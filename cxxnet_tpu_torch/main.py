"""CLI entry point (the JAX package's ``main.py``):

    python -m cxxnet_tpu_torch <config.conf> [key=value ...]

Ported tasks:

* ``task = train``: a fresh model (or ``model_in``, a ``.model`` or a
  ``.ckpt``) trained for ``num_round`` rounds over the ``data = train``
  iterator section, a snapshot in ``model_dir`` every ``save_model``
  rounds (``0000`` before the first): the legacy ``%04d.model``, or
  under ``ckpt_async = 1`` an atomic ``%04d.ckpt`` directory written off
  the training thread (the newest ``ckpt_keep`` kept), each with the
  optimizer state (unless ``save_opt = 0``), the counters, the rng and
  (``ckpt_iter_state = 1``) the train iterator's state.  ``continue =
  1`` resumes from the newest complete snapshot in ``model_dir`` with
  finite parameters, where the run that wrote it stood.  The metrics
  sink gets the JAX package's records (doc/monitor.md): ``run`` at model
  build, ``compile`` (the first dispatch), a ``step`` record per
  ``print_step`` steps, a ``round`` record a round, ``monitor`` / ``nan``
  (``monitor = 1``), ``trace`` / ``layer_profile`` per profile window
  (``prof``) and, on the card, ``mem_profile`` (its first step read
  from the caching allocator), ``anomaly`` / ``flight`` (``sentinel =
  1``), ``ckpt``, ``rollback`` and, last, the ``ledger``.  ``rollback =
  N`` restores the newest finite snapshot when the run diverges
  (``TrainingDiverged``), reseeds the rng and goes on, N times at most.
  A net with ``pairtest`` layers prints their diagnostics (``diag:``,
  the last step's relative errors, and a warning for each over the
  reference's 1e-5) every ``print_step`` steps.  After each round a
  ``[round]\ttrain-<metric>:v\t<eval>-<metric>:v`` line on stderr
  (the train metric under ``eval_train = 1``, then every ``eval = name``
  section).  ``synth_device_data = 1`` trains instead on ``multi_step``
  seeded synthetic batches held on the device, the JAX package's
  no-data entry, drawn with numpy exactly as it draws them.  The train
  loop reads batches through a
  :class:`~.io.device_prefetch.DevicePrefetcher` that stages
  ``prefetch_device`` (default 2) batches onto the device ahead of the
  step on a producer thread (0: inline, still outside the step's
  timer); ``test_io = 1`` runs the host pipeline alone (no staging, no
  update) and prints its examples/sec;
* ``task = finetune``: a fresh model whose layers matching a layer of
  ``model_in`` by name and shapes take its weights, then trained as
  ``task = train``;
* ``task = pred`` / ``pred_raw`` / ``extract``: the ``pred`` iterator
  section's batches through the eval forward of ``model_in``; one line
  per valid row in the ``pred = <file>`` file: the predicted class
  (``pred``), the final node's values (``pred_raw``), or node
  ``extract_node_name``'s values (``extract``: text, or raw float32
  under ``output_format = bin``, with the row width in ``<file>.meta``);
  each emits a ``latency`` record of its per-batch times;
* ``task = serve``: a snapshot (``model_in``) is served to
  ``serve_clients`` concurrent client threads replaying the ``pred``
  iterator section: by default one single-row predict request a row,
  coalesced by the micro-batcher into ``serve_shapes`` bucket dispatches
  of the ``serve_dtype`` variant, the predictions in ``name_pred`` as
  ``task = pred`` writes them; with ``serve_gen = 1`` the rows become
  prompts for the KV-cache decode engine behind the continuous-batching
  step scheduler (speculative with a ``serve_draft_model``, chunked
  prefill with ``decode_prefill_chunk``), the generated ids in
  ``name_pred``.  ``serve_admin_port`` serves ``/metrics`` /
  ``/healthz`` / ``/readyz`` / ``/statusz`` from before warmup to the
  end of the drain; on the micro-batched path a reporter thread emits a
  ``serve_window`` record every ``serve_sentinel_window`` seconds, which
  feeds the serve sentinels (``serve_sentinel = 1``), the SLO burn
  alerts (``serve_slo_*``: ``slo`` records) and the flight capture
  (``serve_flight_*``: one ``serve_flight`` record per anomaly storm).

* ``task = check``: the config lint of ``analysis/``: every key against
  the declared-key registry (did-you-mean suggestions), type, enum and
  range checks, the netconfig's structure, the cross-key rules, what
  the port does not implement, and with ``mem_check = 1`` the OOM
  pre-flight against the card's memory on a trainer built on ``meta``
  tensors.  No device work and no data files.  The findings are
  printed, one ``check`` record lands in the sink, and the exit code is
  1 iff a finding is an error.

Data parallelism (``parallel/``): ``task = train`` / ``finetune`` with a
``dev`` of several ids (``cpu:0-3``, ``gpu:0-3``) starts one rank a
device (:func:`~.parallel.mesh.spawn`; CPU ranks split the host's
cores) and each runs this task on its rows of every batch over the
``mesh`` (one ``data`` axis by default; ``model``, ``seq``,
``expert`` and ``pipe`` axes too: a pipe axis runs the stages of
``pipe_schedule`` over ``pipe_microbatch`` microbatches, and step and
round records carry the analytic ``pipe_bubble_frac``);
``CXN_COORDINATOR`` / ``CXN_NUM_PROC`` / ``CXN_PROC_RANK`` (or the
``dist_*`` keys) join an external group of processes instead, one rank
each, whose iterators read their own shard (``dist_num_worker`` /
``dist_worker_rank``).  Of spawned ranks, rank 0 alone prints, writes
records and writes snapshots (every rank gathers the shards it holds
into them); each process of a ``CXN_*`` launch writes its own;
``test_on_server = 1`` checks after each round that the replicas agree.
A rank that fails fails the command.  ``pred`` / ``pred_raw`` /
``extract`` run on the same mesh: each rank runs the eval forward of its
rows of every batch, the rows are all-gathered in the batch's order and
rank 0 alone writes ``pred`` (and ``.meta``) and the latency record, in
a spawned group and in a ``CXN_*`` launch alike.  Micro-batched
``serve`` too: rank 0 runs the host, the batcher, its clients and the
admin endpoint, and every forward of its engine is one collective
dispatch that the other ranks follow (``serve/engine.py``); incremental
decode (``serve_gen = 1``) refuses a mesh, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ckpt as ckptlib
from .analysis.schema import K
from .ckpt import CKPT_KEYS
from .io.device_prefetch import DevicePrefetcher, item_h2d_sec
from .io.factory import create_iterator, init_iterator
from .monitor import TrainingDiverged, log as mlog
from .monitor.trace import ProfileWindow
from .nnet.trainer import NetTrainer, diagnostics_to_host
from .parallel import mesh as meshlib
from .serve import SERVE_KEYS
from .utils.config import parse_config_file, parse_keyval_args

PORTED_TASKS = ("train", "finetune", "pred", "pred_raw", "extract", "serve",
                "check")

#: keys LearnTask.set_param consumes: the task half of the config
#: surface (the trainer half is nnet/trainer.TRAINER_KEYS), read by the
#: declared-key registry (analysis/registry.py); keep in step with
#: set_param below
TASK_KEYS = (
    K("print_step", "int", lo=1),
    K("continue", "int", lo=0, hi=1),
    K("save_model", "int", lo=0),
    K("start_counter", "int", lo=0),
    K("model_in", "path"), K("model_dir", "path"),
    K("num_round", "int", lo=0), K("max_round", "int", lo=0),
    K("silent", "int", lo=0, hi=1),
    K("task", "enum", choices=("train", "finetune", "pred", "pred_raw",
                               "extract", "check", "serve")),
    K("dev", "str"),
    K("test_io", "int", lo=0, hi=1),
    K("multi_step", "int", lo=0),
    K("prefetch_device", "int", lo=0),
    K("synth_device_data", "int", lo=0, hi=1),
    K("extract_node_name", "str"),
    K("eval_train", "int", lo=0, hi=1),
    K("prof", "path"),
    K("prof_start_step", "int", lo=-1),
    K("prof_num_steps", "int", lo=0),
    K("prof_every", "int", lo=0,
      help="recurring profiling windows: trace every Nth round"),
    K("sentinel", "int", lo=0, hi=1,
      help="EWMA regression sentinels over step time / comm_share / "
           "HBM high-water (anomaly records need metrics_sink)"),
    K("sentinel_rel", "float", lo=0.01, hi=10.0,
      help="relative deviation vs the EWMA that fires an anomaly "
           "(must be > 0: a zero threshold fires on every observation)"),
    K("sentinel_warmup", "int", lo=1),
    K("sentinel_ring", "int", lo=1,
      help="flight-recorder depth: last K step records dumped on an "
           "anomaly or TrainingDiverged"),
    # goodput ledger (monitor/ledger.py): end-of-run wall accounting,
    # emitted from the task's finally so a diverged run still lands it;
    # tools/obsv.py --diff compares two of them
    K("ledger", "int", lo=0, hi=1,
      help="emit the end-of-run goodput ledger record (default 1; "
           "needs metrics_sink, train/finetune tasks only)"),
    K("test_on_server", "int", lo=0, hi=1),
    # OOM pre-flight (analysis/memmodel.py): task=check runs the
    # analytic memory model against the target card's memory
    K("mem_check", "int", lo=0, hi=1,
      help="task=check: error when the estimated peak memory exceeds "
           "the target card's capacity (warn inside mem_margin_pct)"),
    K("mem_margin_pct", "float", lo=0, hi=90,
      help="pre-flight warning margin: warn when the estimate lands "
           "within this % of capacity (default 10)"),
    K("mem_chip", "str",
      help="pre-flight capacity selector (h100 or a full device "
           "name); defaults to dev= when it names a card"),
    # the SPMD deep lint (analysis/spmdlint.py), task = check's third pass
    K("spmd_check", "int", lo=0, hi=1,
      help="task=check: run the SPMD deep lint (default 1; 0 skips the "
           "collective/donation/dtype-flow pass)"),
    # the runtime deliberately tolerates unknown spellings (treated as
    # binary, with a warning) — soft keeps the lint at warn severity
    K("output_format", "enum", choices=("txt", "bin"), soft=True),
    K("dist_coordinator", "str"),
    K("dist_num_proc", "int", lo=1),
    K("dist_proc_rank", "int", lo=0),
    # serving keys (serve/__init__.py declares them next to their
    # consumer, ServeConfig.from_pairs) and checkpoint / rollback keys
    # (ckpt/__init__.py)
) + SERVE_KEYS + CKPT_KEYS

def _cli_rank(rank: int, argv: List[str], threads: int = 0) -> None:
    """One spawned rank of a data-parallel CLI run; ``threads`` > 0 caps
    its intra-op threads (CPU ranks share the host's cores)."""
    if threads:
        torch.set_num_threads(threads)
    code = LearnTask().run(argv)
    if code:
        raise SystemExit(code)


class LearnTask:
    def __init__(self):
        self.task = "train"
        self.name_model_in = "NULL"
        self.name_model_dir = "./"
        self.name_pred = "pred.txt"
        self.print_step = 100
        self.save_period = 1
        self.save_opt = 1
        self.continue_training = 0
        # ckpt_async = 1: round snapshots as atomic NNNN.ckpt directories
        # written off the training thread, the newest ckpt_keep kept;
        # ckpt_iter_state = 1: they carry the train iterator's state
        self.ckpt_async = 0
        self.ckpt_keep = 3
        self.ckpt_iter_state = 1
        self._ckpt_writer = None
        # counter -> seconds the train thread spent on that snapshot;
        # written around submit() here, popped by _ckpt_done on the
        # writer thread
        self._ckpt_blocked_sec: dict = {}
        self._ckpt_lock = threading.Lock()
        self._resume_iter_state = None
        self._warned_iter_capture = False
        # reference default 0: 0000.model is the pre-training snapshot
        # and rounds 1..num_round then train
        self.start_counter = 0
        self.num_round = 10
        self.max_round = 2147483647
        self.cfg: List[Tuple[str, str]] = []
        # the round line carries the train metric (reference default 1)
        self.eval_train = 1
        # steps a round of synth_device_data = 1 takes; grouped dispatch
        # of the JAX package otherwise (the port runs each batch eagerly)
        self.multi_step = 0
        self.synth_device_data = 0
        # test_io = 1: the host input pipeline alone, no staging, no update
        self.test_io = 0
        # staged batches a producer thread keeps ahead of the step (0:
        # staged inline on the consumer thread)
        self.prefetch_device = 2
        self._eval_prefetchers: Optional[list] = None
        self._pred_prefetcher = None
        self.extract_node_name = ""
        # 1 = text rows, 0 = raw float32 rows (task = extract)
        self.output_format = 1
        self.net: Optional[NetTrainer] = None
        self.itr_train = None
        self.itr_pred = None
        self.itr_evals: List = []
        self.eval_names: List[str] = []
        # the last serve_gen run's accounting (counts, rates, latencies)
        self.last_serve: Optional[dict] = None
        # the last train run's per-step losses, step ms and rates, and
        # each round's metric values
        self.last_train: Optional[dict] = None
        # profile windows (doc/monitor.md): the trace directory, the
        # dispatch the window opens before (-1: the round past the first
        # dispatch), its dispatches (0: to the round's end), a recurring
        # window every prof_every rounds
        self.prof_dir = ""
        self.prof_start_step = -1
        self.prof_num_steps = 0
        self.prof_every = 0
        # the last train loop's window and its last trace report
        self.prof_window: Optional[ProfileWindow] = None
        self.last_trace_report: Optional[dict] = None
        # regression sentinels and the flight ring (monitor/sentinel.py)
        self.sentinel = 0
        self.sentinel_rel = 0.2
        self.sentinel_warmup = 3
        self.sentinel_ring = 64
        self._sentinel_bank = None
        self._resume_sentinel_state = None
        # the end-of-run goodput ledger; its wall starts in run(), and it
        # folds the sink from where this session began
        self.ledger = 1
        self._run_t0: Optional[float] = None
        self._sink_offset = 0
        # rollback = N: restore the newest finite snapshot on
        # TrainingDiverged, N times at most
        self.rollback = 0
        # the first dispatch's wall (kernel builds, library autotune,
        # allocator warm-up)
        self.compile_sec: Optional[float] = None
        # the allocator probe of the open profile window's measured step
        self._mem_probe = None
        # task = check's findings
        self.last_check: Optional[list] = None
        # test_on_server = 1: the replica weight check after each round
        self.test_on_server = 0
        # a rank of a spawned data mesh other than rank 0 (dev = cpu:0-3
        # / gpu:0-3): it prints nothing and writes no records and no
        # snapshot, which rank 0 does for all.  A process of a CXN_*
        # launch is its own host and writes its own, as in the JAX
        # package.
        self.quiet_rank = False

    def set_param(self, name: str, val: str) -> None:
        if val == "default":
            return
        if name == "model_in":
            self.name_model_in = val
        elif name == "model_dir":
            self.name_model_dir = val
        elif name == "print_step":
            self.print_step = int(val)
        elif name == "save_model":
            self.save_period = int(val)
        elif name == "save_opt":
            self.save_opt = int(val)
        elif name == "continue":
            self.continue_training = int(val)
        elif name == "ckpt_async":
            self.ckpt_async = int(val)
        elif name == "ckpt_keep":
            self.ckpt_keep = max(int(val), 1)
        elif name == "ckpt_iter_state":
            self.ckpt_iter_state = int(val)
        elif name == "start_counter":
            self.start_counter = int(val)
        elif name == "num_round":
            self.num_round = int(val)
        elif name == "max_round":
            self.max_round = int(val)
        elif name == "silent":
            mlog.set_silent(int(val))
        elif name == "task":
            self.task = val
        elif name == "eval_train":
            self.eval_train = int(val)
        elif name == "multi_step":
            self.multi_step = int(val)
        elif name == "synth_device_data":
            self.synth_device_data = int(val)
        elif name == "test_io":
            self.test_io = int(val)
        elif name == "prefetch_device":
            self.prefetch_device = int(val)
        elif name == "extract_node_name":
            self.extract_node_name = val
        elif name == "output_format":
            # the reference treats anything but "txt" as binary
            if val not in ("txt", "bin"):
                mlog.warn(f"output_format={val!r} not 'txt'/'bin'; "
                          "treating as binary")
            self.output_format = 1 if val == "txt" else 0
        elif name == "prof":
            self.prof_dir = val
        elif name == "prof_start_step":
            self.prof_start_step = int(val)
        elif name == "prof_num_steps":
            self.prof_num_steps = int(val)
        elif name == "prof_every":
            self.prof_every = int(val)
        elif name == "sentinel":
            self.sentinel = int(val)
        elif name == "sentinel_rel":
            self.sentinel_rel = float(val)
        elif name == "sentinel_warmup":
            self.sentinel_warmup = int(val)
        elif name == "sentinel_ring":
            self.sentinel_ring = int(val)
        elif name == "ledger":
            self.ledger = int(val)
        elif name == "rollback":
            self.rollback = int(val)
        elif name == "test_on_server":
            self.test_on_server = int(val)
        self.cfg.append((name, val))

    # ---------------------------------------------------------------- init
    def _create_net(self) -> NetTrainer:
        net = NetTrainer()
        for k, v in self.cfg:
            if k == "metrics_sink" and self.quiet_rank:
                continue  # rank 0 writes the records
            net.set_param(k, v)
        return net

    def _sync_latest_model(self) -> bool:
        """``continue = 1`` (reference SyncLastestModel): restore the
        newest loadable snapshot in ``model_dir``, ``NNNN.ckpt``
        directories and ``NNNN.model`` files alike, from
        ``start_counter`` on, skipping partial or corrupt ones and ones
        whose parameters are not finite."""
        cands = [(c, p) for c, p in
                 ckptlib.list_snapshots(self.name_model_dir)
                 if c >= self.start_counter]
        return self._restore_newest_valid(cands, "continue") is not None

    @staticmethod
    def _reject_nonfinite(net: NetTrainer) -> Optional[str]:
        """Reject hook of the resume scan: poisoned params would only
        diverge again."""
        finite = all(bool(torch.isfinite(p).all())
                     for g in net.params.values() for p in g.values())
        return None if finite else "carries non-finite params; walking back"

    def _restore_newest_valid(self, cands, who: str):
        """Walk ``(counter, path)`` candidates newest first and restore the
        first loadable one into ``self.net``: partial or corrupt ``.ckpt``
        directories (what a kill mid-write leaves) are skipped with a
        warning, torn ``.model`` files when they fail to load, and
        :meth:`_reject_nonfinite` refuses the rest.  Shared by
        ``continue = 1`` and rollback (``who`` names it in the warnings).
        Sets ``start_counter`` past the restored round, holds its
        iterator and sentinel state for the loop, and returns
        ``(counter, path)``, or None."""
        for counter, path in reversed(cands):
            is_ckpt = path.endswith(".ckpt")
            if is_ckpt and ckptlib.validate_snapshot(path) is None:
                mlog.warn(f"{who}: skipping partial/corrupt snapshot "  # disclint: ok(warn-once)
                          f"{path}")
                continue
            net = self._create_net()
            try:
                net.load_model(path, validated=is_ckpt)
            except Exception as e:  # noqa: BLE001 — a torn legacy file
                net.metrics.close()
                mlog.warn(f"{who}: snapshot {path} failed to load ({e});"  # disclint: ok(warn-once)
                          " trying the previous one")
                continue
            why = self._reject_nonfinite(net)
            if why:
                net.metrics.close()
                mlog.warn(f"{who}: snapshot {path} {why}")  # disclint: ok(warn-once)
                continue
            old, self.net = self.net, net
            if old is not None:
                old.metrics.close()
            self.start_counter = counter + 1
            self._stash_resume_state(net.loaded_extra)
            return counter, path
        return None

    def _stash_resume_state(self, extra) -> None:
        """Hold a loaded snapshot's iterator state until the iterators
        exist, and its sentinel state until the loop's sentinel bank
        does."""
        if not extra:
            return
        if self.ckpt_iter_state:
            self._resume_iter_state = extra.get("iter_state")
        self._resume_sentinel_state = extra.get("sentinel_state")

    def _apply_iter_resume(self) -> None:
        st, self._resume_iter_state = self._resume_iter_state, None
        if st and self.itr_train is not None:
            try:
                self.itr_train.set_state(st)
            except Exception as e:  # noqa: BLE001 — resume best-effort
                mlog.warn(f"iterator state restore failed ({e}); the "
                          "train iterator resumes cold")

    def init(self) -> None:
        if self.task == "train" and self.continue_training:
            if self._sync_latest_model():
                mlog.notice("Init: Continue training from round "
                            f"{self.start_counter}")
                self._create_iterators()
                self._apply_iter_resume()
                return
            raise RuntimeError(
                "Init: cannot find models for continue training; "
                "specify model_in instead")
        self.continue_training = 0
        self.net = self._create_net()
        if self.name_model_in == "NULL":
            if self.task != "train":
                raise ValueError(f"task = {self.task}: must specify "
                                 "model_in")
            self.net.init_model()
        elif self.task == "finetune":
            self.net.init_model()
            self.net.copy_model_from(self.name_model_in)
        else:
            self.net.load_model(self.name_model_in)
            m = re.search(r"(\d+)\.(?:model|ckpt)$",
                          self.name_model_in.rstrip(os.sep))
            if m and self.task == "train":
                self.start_counter = int(m.group(1)) + 1
        self._create_iterators()

    def _create_iterators(self) -> None:
        """Section scanner (reference CreateIterators): ``data`` is the
        train stream and each ``eval = name`` an evaluation stream (made
        for every task but ``pred``, as in the JAX package), ``pred`` the
        input of ``pred`` / ``pred_raw`` / ``extract`` and the request
        stream of ``serve``.  ``synth_device_data = 1`` reads no data."""
        if self.synth_device_data:
            return
        flag = 0
        evname = ""
        itcfg: List[Tuple[str, str]] = []
        defcfg: List[Tuple[str, str]] = []
        for name, val in self.cfg:
            if name == "data":
                flag = 1
                continue
            if name == "eval":
                evname = val
                flag = 2
                continue
            if name == "pred":
                flag = 3
                self.name_pred = val
                continue
            if name == "iter" and val == "end":
                assert flag != 0, "wrong configuration file"
                if flag == 1 and self.task != "pred":
                    assert self.itr_train is None, "can only have one data"
                    self.itr_train = create_iterator(itcfg)
                if flag == 2 and self.task != "pred":
                    self.itr_evals.append(create_iterator(itcfg))
                    self.eval_names.append(evname)
                if flag == 3 and self.task in ("pred", "pred_raw",
                                               "extract", "serve"):
                    assert self.itr_pred is None, \
                        "can only have one pred data"
                    self.itr_pred = create_iterator(itcfg)
                flag = 0
                itcfg = []
                continue
            (itcfg if flag != 0 else defcfg).append((name, val))
        # input_s2d: emit space-to-depth batches from the host pipeline,
        # wrapped before init so a threadbuffer's producer thread runs the
        # transform in the prefetch overlap
        self.itr_train = self._wrap_s2d(self.itr_train)
        self.itr_evals = [self._wrap_s2d(it) for it in self.itr_evals]
        self.itr_pred = self._wrap_s2d(self.itr_pred)
        for it in [self.itr_train, self.itr_pred] + self.itr_evals:
            if it is not None:
                init_iterator(it, defcfg)

    def _wrap_s2d(self, it):
        """Under ``input_s2d = 1``, an :class:`~.io.iter_proc.S2DEmitIterator`
        spliced beneath the deepest buffering stage of ``it`` (so the
        transform runs on the threadbuffer's producer thread, or once at a
        membuffer's fill), or on top of a chain without one."""
        s2d_args = getattr(self.net, "_s2d_args", None) if self.net else None
        if s2d_args is None or it is None:
            return it
        from .io.iter_proc import (DenseBufferIterator, S2DEmitIterator,
                                   ThreadBufferIterator)
        deepest = None
        cur = it
        while getattr(cur, "base", None) is not None:
            if isinstance(cur, (ThreadBufferIterator, DenseBufferIterator)):
                deepest = cur
            cur = cur.base
        if deepest is not None:
            deepest.base = S2DEmitIterator(deepest.base, s2d_args)
            return it
        return S2DEmitIterator(it, s2d_args)

    def _eval_sources(self):
        """The eval iterators, each behind a device prefetcher (a batch an
        item, staged ``prefetch_device`` ahead) when prefetching is on;
        made once and reused every round."""
        if self.prefetch_device <= 0 or self.net is None:
            return self.itr_evals
        if self._eval_prefetchers is None:
            self._eval_prefetchers = [
                DevicePrefetcher(it, self.net, depth=self.prefetch_device,
                                 metrics=self.net.metrics, for_eval=True)
                for it in self.itr_evals]
        return self._eval_prefetchers

    def _pred_source(self):
        """The pred iterator, staged a batch an item ahead of the inference
        loop when prefetching is on."""
        if self.prefetch_device <= 0 or self.itr_pred is None:
            return self.itr_pred
        if self._pred_prefetcher is None:
            self._pred_prefetcher = DevicePrefetcher(
                self.itr_pred, self.net, depth=self.prefetch_device,
                metrics=self.net.metrics, for_eval=True)
        return self._pred_prefetcher

    def _close_prefetchers(self) -> None:
        """Join every eval / pred prefetcher's producer thread (the train
        loop closes its own).  Idempotent: the tasks call it from their
        ``finally`` so a raise mid-round leaves no staging thread behind,
        and :meth:`run` keeps it as a backstop."""
        for pf in (self._eval_prefetchers or []) + \
                ([self._pred_prefetcher] if self._pred_prefetcher else []):
            pf.close()
        self._eval_prefetchers = None
        self._pred_prefetcher = None

    # ---------------------------------------------------------------- train
    def _ckpt_extra_state(self, capture_iter: bool = True) -> dict:
        """Resume state beside the trainer's in a snapshot: the train
        iterator chain's state, taken at a round boundary (warned once
        and left out when a stage cannot give it), and the sentinels'
        baselines and flight ring.  ``capture_iter =
        False`` for the round-0 save: an iterator resuming cold is its
        round-0 state."""
        extra = {}
        if capture_iter and self.ckpt_iter_state \
                and self.itr_train is not None:
            try:
                extra["iter_state"] = self.itr_train.state()
            except Exception as e:  # noqa: BLE001 — snapshot best-effort
                if not self._warned_iter_capture:
                    self._warned_iter_capture = True
                    mlog.warn(f"iterator state capture failed ({e}); "
                              "snapshots resume the iterator cold")
        if self._sentinel_bank is not None:
            extra["sentinel_state"] = self._sentinel_bank.state()
        return extra

    def _ckpt_done(self, stats: dict) -> None:
        """The async writer's completion hook (on its thread): the
        ``ckpt`` record lands as soon as the manifest committed."""
        metrics = self.net.metrics
        with self._ckpt_lock:
            blocked = self._ckpt_blocked_sec.pop(stats["counter"], 0.0)
        metrics.counter_inc("ckpt_saves")
        metrics.emit("ckpt", round=stats["counter"], path=stats["path"],
                     async_write=1, shards=stats["shards"],
                     bytes=stats["bytes"],
                     write_sec=round(stats["write_sec"], 4),
                     blocked_sec=round(blocked, 4),
                     pruned=stats["pruned"], keep=self.ckpt_keep)
        mlog.info(f"checkpoint {stats['path']}: {stats['bytes']} bytes "
                  f"in {stats['write_sec']:.3f} sec off-thread "
                  f"(loop blocked {blocked:.3f} sec)")

    def _save_model(self, capture_iter: bool = True) -> None:
        """Round-boundary snapshot every ``save_model`` rounds (counts the
        round either way): under ``ckpt_async = 1`` the host pull here
        and an atomic ``%04d.ckpt`` written by the writer thread, else a
        legacy ``%04d.model`` written here.  One ``ckpt`` record each."""
        if self._ckpt_writer is not None:
            # a writer failure latched since the last save surfaces here,
            # at the next round boundary
            self._ckpt_writer.poll()
        counter = self.start_counter
        self.start_counter += 1
        if self.save_period == 0 or counter % self.save_period != 0:
            return
        if self.quiet_rank:
            # the gathers rank 0 makes to write, made here too
            if self.ckpt_async:
                self.net.checkpoint_payload(with_opt=bool(self.save_opt))
            else:
                self.net.save_model("", with_opt_state=bool(self.save_opt),
                                    write=False)
            return
        os.makedirs(self.name_model_dir, exist_ok=True)
        extra_state = self._ckpt_extra_state(capture_iter)
        metrics = self.net.metrics
        t0 = time.perf_counter()
        if self.ckpt_async:
            from .ckpt.writer import AsyncCheckpointWriter
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter(
                    on_done=self._ckpt_done)
            shards, meta = self.net.checkpoint_payload(
                with_opt=bool(self.save_opt), extra_state=extra_state)
            path = ckptlib.snapshot_path(self.name_model_dir, counter)
            # the pull's time is stashed before submit, so the completion
            # hook always finds an entry; the backpressure block is added
            # after, unless the record has landed already
            pull = time.perf_counter() - t0
            with self._ckpt_lock:
                self._ckpt_blocked_sec[counter] = pull
            block = self._ckpt_writer.submit(
                path, shards, meta, counter=counter, keep=self.ckpt_keep,
                tracer=metrics.tracer)
            with self._ckpt_lock:
                if counter in self._ckpt_blocked_sec:
                    self._ckpt_blocked_sec[counter] = pull + block
            # what the train thread paid for this snapshot: the host pull
            # and the queue's backpressure
            tr = metrics.tracer
            if tr.enabled:
                tr.emit("ckpt_blocked", t0, time.perf_counter(),
                        counter=counter)
            return
        path = os.path.join(self.name_model_dir, f"{counter:04d}.model")
        self.net.save_model(path, with_opt_state=bool(self.save_opt),
                            extra_state=extra_state)
        wall = time.perf_counter() - t0
        metrics.counter_inc("ckpt_saves")
        metrics.emit("ckpt", round=counter, path=path, async_write=0,
                     shards=1, bytes=os.path.getsize(path),
                     write_sec=round(wall, 4), blocked_sec=round(wall, 4),
                     pruned=0, keep=self.ckpt_keep)

    def task_train(self) -> None:
        """``task = train``: rounds of updates over the train iterator
        (or the synthetic device batches) under the rollback guard.  Each
        step ends in a device synchronise, so its host time is the step's
        time on the card; the first dispatch of the session (kernel
        builds, library autotune, allocator warm-up) is the ``compile``
        record and stays out of the step percentiles and the rates.  The
        ``0000`` snapshot is taken before the first round of a fresh
        model (not under ``continue = 1``).  ``rollback = N``: on
        :class:`~.monitor.TrainingDiverged` (``monitor_nan = fatal``) the
        newest snapshot with finite parameters is restored, the rng
        reseeded past the bad window (``NetTrainer.reseed_rng``) and the
        loop entered again, N times at most before the exception goes
        on.  The async writer is drained and closed at the end, and a
        failure it latched fails the run."""
        start = time.time()
        self._losses: List[float] = []
        self._step_ms: List[float] = []
        # each step's diagnostics (pairtest nets only): kept on the device
        # and read in one transfer at each print_step and at the end
        self._diags: List[Dict[str, float]] = []
        self._diags_dev: List[Dict[str, torch.Tensor]] = []
        self._has_diags = self.net.has_diagnostics
        self._evals: List[dict] = []
        self._rounds: List[dict] = []
        attempt = 0
        try:
            if self.name_model_in == "NULL" and not self.continue_training:
                self._save_model(capture_iter=False)
            while True:
                try:
                    if self.synth_device_data:
                        self._train_synth_device()
                    else:
                        self._train_rounds(start)
                    break
                except TrainingDiverged as e:
                    if attempt >= self.rollback \
                            or not self._rollback_restore(e, attempt + 1):
                        raise
                    attempt += 1
            if self._ckpt_writer is not None:
                # closed here, outside the finally: a latched writer
                # failure fails the run
                w, self._ckpt_writer = self._ckpt_writer, None
                w.close()
        finally:
            if self._ckpt_writer is not None:
                # an exception is on its way out: do not mask it
                w, self._ckpt_writer = self._ckpt_writer, None
                try:
                    w.close()
                except Exception as e:  # noqa: BLE001
                    mlog.warn(f"checkpoint writer close failed: {e}")
        tail = self._step_ms[1:] or self._step_ms
        p50 = float(np.median(tail)) if tail else 0.0
        seq = int(np.prod(self.net.net.node_shapes[0][1:]))
        self._read_diags()
        self.last_train = dict(
            losses=self._losses, step_ms=self._step_ms, step_p50_ms=p50,
            tokens_per_sec=(self.net.batch_size * seq / (p50 / 1e3)
                            if p50 else 0.0),
            examples_per_sec=(self.net.batch_size / (p50 / 1e3)
                              if p50 else 0.0),
            steps=len(self._losses), evals=self._evals, rounds=self._rounds,
            compile_sec=self.compile_sec, diags=self._diags)
        mlog.info(f"\nupdating end, {int(time.time() - start)} sec in all")

    def _rollback_restore(self, exc: BaseException, attempt: int) -> bool:
        """Restore the newest loadable snapshot before the round that
        diverged whose parameters are finite, reseed its rng and emit a
        ``rollback`` record; False when there is none (the caller
        re-raises)."""
        died_round = self.start_counter
        if self._ckpt_writer is not None:
            # "newest" counts only once an in-flight write committed; a
            # latched writer failure raises here
            self._ckpt_writer.drain()
        # every rank reads what rank 0 committed
        meshlib.barrier(self.net.mesh)
        cands = [(c, p) for c, p in
                 ckptlib.list_snapshots(self.name_model_dir)
                 if c < died_round]
        restored = self._restore_newest_valid(cands, "rollback")
        if restored is None:
            mlog.warn(f"rollback: no finite snapshot found in "
                      f"{self.name_model_dir}; re-raising")
            return False
        counter, path = restored
        self.net.reseed_rng(attempt)
        self._apply_iter_resume()
        self.net.metrics.counter_inc("rollbacks")
        self.net.metrics.emit(
            "rollback", retry=attempt, max_retry=self.rollback,
            from_round=died_round, restored_round=counter, path=path,
            reason=f"{type(exc).__name__}: {exc}")
        mlog.result(
            f"rollback {attempt}/{self.rollback}: {type(exc).__name__} in "
            f"round {died_round}; restored {path}, reseeded rng, resuming "
            f"from round {self.start_counter}")
        return True

    def _timed_step(self, step) -> float:
        """Run ``step()`` (one update), wait for the device, and record
        its loss and time; returns the time in seconds.  The session's
        first dispatch is the ``compile`` record instead of a step
        sample."""
        t0 = time.perf_counter()
        step()
        self.net.sync()
        dt = time.perf_counter() - t0
        self._losses.append(float(self.net.last_loss))
        self._step_ms.append(dt * 1e3)
        if self._has_diags:
            self._diags_dev.append(self.net.last_diags)
        if self.compile_sec is None:
            self.compile_sec = dt
            self.net.metrics.emit("compile", compile_sec=round(dt, 3),
                                  round=self.start_counter - 1)
            mlog.info(f"compile: {dt:.1f} sec (first dispatch, excluded "
                      "from examples/sec)")
        else:
            self.net.metrics.observe("step_latency_sec", dt)
        return dt

    def _open_sentinels(self) -> None:
        """``sentinel = 1`` with a sink: this loop's sentinel bank, its
        baselines carried on from a resumed snapshot."""
        metrics = self.net.metrics
        self._sentinel_bank = None
        if not self.sentinel:
            return
        if not metrics.active:
            mlog.warn("sentinel=1 without metrics_sink: sentinels disarmed")
            return
        from .monitor.sentinel import SentinelBank
        self._sentinel_bank = SentinelBank(
            metrics, rel=self.sentinel_rel, warmup=self.sentinel_warmup,
            ring=self.sentinel_ring)
        if self._resume_sentinel_state:
            self._sentinel_bank.set_state(self._resume_sentinel_state)
            self._resume_sentinel_state = None
        if not self.net.memory_gauges():
            mlog.warn("sentinel: this device reports no allocator memory; "
                      "the HBM watcher stays unarmed")

    def _train_rounds(self, start: float) -> None:
        """Rounds over the train iterator.  Batches come through a
        :class:`~.io.device_prefetch.DevicePrefetcher`, so the step's
        timer holds the update alone; under ``test_io = 1`` the host
        iterator is read alone.  Every ``print_step`` steps a ``step``
        record and after each round a ``round`` record carry the host
        wall split: ``iter_wait_sec`` (the loop blocked on input: the
        host iterator when staging inline, the staging queue when
        prefetching), ``dispatch_sec`` (the steps), ``h2d_sec`` (the
        staging wall: off the loop when prefetching), ``staging_depth``
        (staged items ready at a get) and ``examples_per_sec``.  A
        profile window (``prof``) opens and closes around dispatches
        here; the sentinels watch the records; a raise mid-round dumps
        the flight ring first."""
        net = self.net
        metrics = net.metrics
        if self.itr_train is None:
            raise RuntimeError("task = train but the config has no "
                               "'data = train' iterator section")
        if self.test_io:
            mlog.notice("start I/O test")
        if self.prof_every > 0 and self.prof_start_step >= 0:
            mlog.warn("prof_every ignored: prof_start_step pins a one-shot "
                      "step-addressed window")
            self.prof_every = 0
        prof = ProfileWindow(self.prof_dir, self.prof_start_step,
                             self.prof_num_steps, every=self.prof_every,
                             net=net.net, device=net.device)
        self.prof_window = prof
        self._open_sentinels()
        bank = self._sentinel_bank
        will_run = min(self.num_round - self.start_counter + 1,
                       self.max_round)
        prof_round = 1 if will_run > 1 else 0
        dispatches = rounds_done = 0
        src = None if self.test_io else DevicePrefetcher(
            self.itr_train, net, depth=self.prefetch_device,
            metrics=metrics)
        cc = self.max_round
        try:
            while self.start_counter <= self.num_round and cc > 0:
                cc -= 1
                mlog.info(f"update round {self.start_counter - 1}")
                prof.maybe_start_round(rounds_done, prof_round)
                net.start_round(self.start_counter)
                round_t0 = time.perf_counter()
                (src or self.itr_train).before_first()
                sample_counter = n_round = 0
                # the window since the last record, and the round's totals
                win = dict(n=0, t=round_t0, wait=0.0, h2d=0.0, disp=0.0,
                           depth=0, gets=0, ticks=net.monitor_ticks,
                           prof=False)
                wait_total = h2d_total = disp_total = 0.0
                while True:
                    t0 = time.perf_counter()
                    if src is None:
                        batch = self.itr_train.next()
                        wait, h2d = time.perf_counter() - t0, 0.0
                        batches = [] if batch is None else [batch]
                    else:
                        item = src.next()
                        wall = time.perf_counter() - t0
                        if src.async_:
                            wait = wall
                            win["depth"] += src.last_depth
                            win["gets"] += 1
                        else:
                            wait = src.last_wait_sec
                        h2d = 0.0 if item is None else item_h2d_sec(item)
                        batches = item or []
                    win["wait"] += wait
                    win["h2d"] += h2d
                    wait_total += wait
                    h2d_total += h2d
                    if not batches:
                        break
                    for b in batches:
                        first = False
                        if src is not None:
                            prof.maybe_start_step(dispatches)
                            dispatches += 1
                            first = self.compile_sec is None
                            self._arm_mem_probe(prof)
                            dt = self._timed_step(lambda: net.update(b))
                            if first:
                                # the rates start after the compile
                                win.update(n=0, t=time.perf_counter(),
                                           ticks=net.monitor_ticks)
                            else:
                                win["disp"] += dt
                                disp_total += dt
                            # a profiled dispatch: the window's open,
                            # tracing and close slow this window
                            win["prof"] = win["prof"] or prof.active
                            if prof.after_step():
                                mlog.info("profile trace written to "
                                          f"{prof.last_window_dir}")
                                self._emit_trace_report(prof)
                        sample_counter += 1
                        n_real = b.batch_size - b.num_batch_padd
                        n_round += n_real
                        if not first:
                            win["n"] += n_real
                        if sample_counter % self.print_step == 0:
                            self._window_record(win, sample_counter, start,
                                                src is not None, bank)
                if prof.round_end():
                    mlog.info(f"profile trace written to "
                              f"{prof.last_window_dir}")
                    self._emit_trace_report(prof)
                rounds_done += 1
                train_wall = time.perf_counter() - round_t0
                self._check_replicas()
                evals = {}
                if not self.test_io:
                    line = f"[{self.start_counter}]"
                    if self.eval_train:
                        line += net.train_metric.print_line("train")
                        evals.update(net.train_metric.values("train"))
                    for it, name in zip(self._eval_sources(),
                                        self.eval_names):
                        line += net.evaluate(it, name)
                        evals.update(net.metric.values(name))
                    self._evals.append(evals)
                    mlog.result(line)
                rec = dict(round=self.start_counter,
                           wall_sec=round(train_wall, 4),
                           eval_sec=round(time.perf_counter() - round_t0
                                          - train_wall, 4),
                           examples=n_round,
                           examples_per_sec=round(
                               n_round / max(train_wall, 1e-9), 1),
                           iter_wait_sec=round(wait_total, 4),
                           dispatch_sec=round(disp_total, 4),
                           h2d_sec=round(h2d_total, 4),
                           train_step_traces=metrics.counters.get(
                               "train_step_traces", 0),
                           eval_step_traces=metrics.counters.get(
                               "eval_step_traces", 0),
                           **evals)
                if rounds_done == 1 and self.compile_sec is not None:
                    rec["compile_sec"] = round(self.compile_sec, 3)
                if net.pipe_bubble_frac:
                    # the ledger carves the fill / drain share out of
                    # dispatch
                    rec["pipe_bubble_frac"] = round(net.pipe_bubble_frac, 4)
                rec.update(net.memory_gauges())
                self._rounds.append(rec)
                metrics.emit("round", **rec)
                if bank is not None:
                    bank.observe_round(rec)
                if self.test_io:
                    mlog.info(f"round {self.start_counter - 1:8d}: I/O test "
                              f"{n_round} examples in {train_wall:.2f} sec, "
                              f"{rec['examples_per_sec']:.1f} examples/sec")
                self._save_model()
        except BaseException as e:
            # the steps leading into the failure land before it goes on
            if bank is not None:
                bank.flight_dump(f"{type(e).__name__}: {e}")
            raise
        finally:
            # no staging thread outlives the loop, a raise mid-round
            # included
            if src is not None:
                src.close()
            self._close_prefetchers()
            if prof.active:
                # a window the run never closed (past the last dispatch,
                # or a raise inside it): its reports still land; a flush
                # failure must not mask the exception on its way out
                try:
                    prof.stop()
                    mlog.info(f"profile trace written to "
                              f"{prof.last_window_dir} (window truncated "
                              "at training end)")
                    self._emit_trace_report(prof)
                except Exception as pe:  # noqa: BLE001
                    mlog.warn(f"profile window flush failed: {pe}")

    def _check_replicas(self) -> None:
        """``test_on_server = 1``: after each round the replicas' weights,
        optimizer state and buffers must agree exactly (the reference's
        weight check, async_updater-inl.hpp:144-154)."""
        if not self.test_on_server:
            return
        drift = self.net.check_weight_consistency()
        if drift != 0.0:
            raise RuntimeError(
                f"replica weights diverged (max abs diff {drift})")

    def _window_record(self, win: dict, step: int, start: float,
                       staged: bool, bank) -> None:
        """The ``print_step`` line and (unless ``test_io = 1``) the
        ``step`` record of the window in ``win``, which then restarts."""
        net = self.net
        now = time.perf_counter()
        rate = win["n"] / max(now - win["t"], 1e-9)
        head = (f"round {self.start_counter - 1:8d}:[{step:8d}] "
                f"{int(time.time() - start)} sec elapsed")
        if not staged:
            mlog.info(f"{head}, {rate:.1f} examples/sec")
        else:
            loss = self._losses[-1]
            rec = dict(round=self.start_counter - 1, step=step,
                       global_step=net.sample_counter,
                       elapsed_sec=round(time.time() - start, 3),
                       examples_per_sec=round(rate, 1),
                       iter_wait_sec=round(win["wait"], 4),
                       dispatch_sec=round(win["disp"], 4),
                       h2d_sec=round(win["h2d"], 4),
                       staging_depth=round(win["depth"] / win["gets"], 2)
                       if win["gets"] else 0.0,
                       loss=loss)
            if net.pipe_bubble_frac:
                rec["pipe_bubble_frac"] = round(net.pipe_bubble_frac, 4)
            net.metrics.emit("step", **rec)
            if bank is not None:
                bank.observe_step(rec, judge=self._plain_window(win))
            mlog.info(f"{head}, loss {loss:.4f}, "
                      f"{self._step_ms[-1]:.1f} ms/step, "
                      f"{rate:.1f} examples/sec")
        self._report_diagnostics()
        win.update(n=0, t=now, wait=0.0, h2d=0.0, disp=0.0, depth=0, gets=0,
                   ticks=self.net.monitor_ticks, prof=False)

    def _report_diagnostics(self) -> None:
        """Print the last step's diagnostics (pairtest forward / backward
        / weight relative errors), and warn for each value over the
        reference's 1e-5, the way the reference prints exceedances to
        stderr (pairtest_layer-inl.hpp:190-196)."""
        self._read_diags()
        diags = self._diags[-1] if self._diags else {}
        if not diags:
            return
        from .layers.pairtest import PAIRTEST_RTOL
        parts, bad = [], []
        for k in sorted(diags):
            v = diags[k]
            parts.append(f"{k}={v:.3g}")
            if k.endswith("_rel_err") and not v <= PAIRTEST_RTOL:
                bad.append(f"{k}: err={v:g} exceeds {PAIRTEST_RTOL:g}")
        mlog.info("diag: " + " ".join(parts))
        for b in bad:  # one line per exceeded pairtest diag, bounded
            mlog.warn(b)  # disclint: ok(warn-once)

    def _read_diags(self) -> None:
        """Move the steps' diagnostics kept on the device to the host."""
        if self._diags_dev:
            self._diags.extend(diagnostics_to_host(self._diags_dev))
            self._diags_dev = []

    def _plain_window(self, win: dict) -> bool:
        """Whether the throughput sentinel judges the window in ``win``:
        not when the plane's own work slowed it, a profiled dispatch (the
        profiler's start, tracing, trace export and reports) or more
        monitor ticks than every window holds (``print_step //
        monitor_interval``), which would read as a regression on a
        healthy run."""
        net = self.net
        least = (self.print_step // net.monitor_interval
                 if net.monitor and net.monitor_interval > 0 else 0)
        return not win["prof"] and \
            net.monitor_ticks - win["ticks"] <= least

    def _emit_trace_report(self, prof: ProfileWindow) -> None:
        """The reports of one closed profile window, read from its trace
        once: the ``comm_sec`` / ``overlap_frac`` gauges, a ``trace``
        record and a ``layer_profile`` record.  A trace holding fewer
        events of any hand-written kernel than its wrappers launched in
        the window lost device events: warned, and its ``device_sec``
        (and ``comm_share``) left out rather than reported low.  A
        failure here never stops training."""
        from .monitor import trace
        metrics = self.net.metrics
        steps = max(prof.last_window_steps, 1)
        launches = sum(prof.last_launches.values())
        try:
            events = trace.window_events(trace.load_trace(prof.last_trace))
            rep = trace.comm_report_in(events, steps=steps)
            short = trace.kernel_shortfall(events, prof.last_launches)
        except Exception as e:  # noqa: BLE001 — telemetry only
            mlog.warn(f"trace summary of {prof.last_window_dir} failed: {e}")
            return
        lost = sum(n - got for n, got in short.values())
        if lost:
            mlog.warn(f"profile window {prof.last_window_dir}: the trace "
                      f"lost {lost} events of hand-written kernels ("
                      + ", ".join(f"{k}: {got} of {n}"
                                  for k, (n, got) in sorted(short.items()))
                      + "); device_sec left out")
            rep.pop("device_sec")
            rep.pop("comm_share")
        self.last_trace_report = dict(rep, lost_events=lost, short=short,
                                      launches=launches)
        metrics.set_gauge("comm_sec", rep["comm_sec"])
        metrics.set_gauge("overlap_frac", rep["overlap_frac"])
        if metrics.active:
            metrics.emit("trace", round=self.start_counter - 1, **rep)
            if self._sentinel_bank is not None:
                self._sentinel_bank.observe_trace(
                    dict(rep, round=self.start_counter - 1))
            self._emit_layer_profile(events, steps)
            self._emit_mem_profile()

    def _device_name(self) -> str:
        """The card's name (the cost model's table key), "" on the CPU."""
        dev = self.net.device
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""

    def _arm_mem_probe(self, prof: ProfileWindow) -> None:
        """On the card with a sink, the first dispatch of each profile
        window reads the caching allocator connection by connection
        (``NetTrainer.arm_mem_probe``) for the window's ``mem_profile``
        record."""
        net = self.net
        if prof.active and self._mem_probe is None \
                and net.device.type == "cuda" and net.metrics.active:
            self._mem_probe = net.arm_mem_probe()

    def _emit_mem_profile(self) -> None:
        """One ``mem_profile`` record (monitor/memory.py): the window's
        measured step, connection by connection, beside the trainer's
        parameter / optimizer bytes and the analytic memory model
        (analysis/memmodel.py), the card's capacity and the allocator
        gauges."""
        from .analysis import costmodel, memmodel
        from .monitor import memory as memlib
        probe, self._mem_probe = self._mem_probe, None
        if probe is None or not probe.done:
            return
        net = self.net
        try:
            model = memmodel.layer_mem(net)
            table = memlib.mem_table(
                probe, param_rows=memmodel.param_rows(net),
                # the measured row is param + opt + live activation, so
                # the transient gradient stays out of the model's row
                model_rows={s: {k: v for k, v in r.items()
                                if k != "grad_bytes"}
                            for s, r in model.items()})
            table["model"] = memmodel.totals(net, model)
            cap = costmodel.hbm_bytes(self._device_name(), net.device)
            if cap:
                table["hbm_capacity_bytes"] = int(cap)
            table.update(net.memory_gauges())
        except Exception as e:  # noqa: BLE001 — telemetry only
            mlog.warn(f"memory attribution failed: {e}")
            return
        net.metrics.emit("mem_profile", round=self.start_counter - 1,
                         **table)
        if not mlog.is_silent() and table["rows"]:
            top = ", ".join(f"{r['layer']} {r['total_bytes'] / 1e6:.2f} MB"
                            for r in table["rows"][:3])
            mlog.info(f"mem_profile: peak live "
                      f"{table['peak_live_bytes'] / 1e6:.2f} MB over the "
                      f"step's start at {table['peak_frac']:.0%} of the "
                      f"step; top: {top}")

    def _emit_layer_profile(self, events, steps: int) -> None:
        """One ``layer_profile`` record: the window's device time per
        connection (monitor/attribution.py) beside the analytic cost
        model (analysis/costmodel.py) and, on the card, its peaks."""
        from .analysis import costmodel
        from .monitor import attribution
        net = self.net
        name = self._device_name()
        try:
            table = attribution.layer_table(
                events, net.layer_scopes(), steps=steps,
                costs=costmodel.layer_costs(net.net),
                peak_flops=costmodel.peak_flops(name),
                peak_bw=costmodel.peak_bw(name))
        except Exception as e:  # noqa: BLE001 — telemetry only
            mlog.warn(f"layer attribution failed: {e}")
            return
        self.net.metrics.emit("layer_profile", round=self.start_counter - 1,
                              **table)
        if not mlog.is_silent() and table["rows"]:
            top = ", ".join(f"{r['layer']} {r['device_ms']:.3g} ms"
                            for r in table["rows"][:3])
            mlog.info(f"layer_profile: {table['attributed_ms']:.3g} of "
                      f"{table['device_total_ms']:.3g} ms/step attributed "
                      f"({table['coverage'] * 100:.0f}%); top: {top}")

    def _train_synth_device(self) -> None:
        """``synth_device_data = 1``: every round takes ``multi_step``
        steps (at least 1) over one stack of seeded synthetic batches
        made once and held on the device: uniform [0, 1) data and
        uniform class labels from ``numpy.random.RandomState(0)``, drawn
        in the JAX package's order, so both packages see the same
        batches (under ``input_s2d = 1`` staged once in space-to-depth
        form, as the JAX package stages them).  A ``step`` record a
        round; ``test_on_server = 1`` checks the replicas after each."""
        net = self.net
        k = max(self.multi_step, 1)
        shape = net.net.node_shapes[0]
        nclass = net.net.node_shapes[net.net.final_node][-1]
        rnd = np.random.RandomState(0)
        datas = torch.from_numpy(rnd.rand(k, *shape).astype(np.float32)) \
            .to(net.device).to(net.dtype)
        labels = torch.from_numpy(rnd.randint(0, nclass, (k, shape[0], 1))
                                  .astype(np.float32)).to(net.device)
        # input_s2d = 1: the stack staged in space-to-depth form once
        staged = net.stage_input(datas.reshape(-1, *shape[1:]))
        datas = staged.reshape(k, shape[0], *staged.shape[1:])
        while self.start_counter <= self.num_round:
            net.start_round(self.start_counter)
            t = sum(self._timed_step(lambda: net.update_step(
                {0: datas[j]}, net.label_info(labels[j])))
                for j in range(k))
            self._check_replicas()
            mlog.info(f"round {self.start_counter - 1:8d}: synth-device "
                      f"{k} steps, {shape[0] * k / t:.1f} examples/sec")
            net.metrics.emit(
                "step", round=self.start_counter - 1, step=k,
                global_step=net.sample_counter, synth_device=1,
                examples_per_sec=round(shape[0] * k / t, 1),
                dispatch_sec=round(t, 4), iter_wait_sec=0.0,
                loss=self._losses[-1])
            self._save_model()

    def _emit_ledger(self) -> None:
        """The end-of-run goodput ledger (monitor/ledger.py): this
        session's records, re-read from the sink (flushed per record, a
        diverged run's flight dump included), folded into one ``ledger``
        record, the stream's last.  Called from :meth:`run`'s finally
        before the sink closes; ``train`` / ``finetune`` only."""
        if not self.ledger or self.task not in ("train", "finetune"):
            return
        net = self.net
        if net is None or not net.metrics.active or self._run_t0 is None:
            return
        try:
            from .monitor import ledger as ledgerlib
            recs = ledgerlib.load_records(net.metrics.sink_path,
                                          who="ledger",
                                          offset=self._sink_offset)
            led = ledgerlib.build_ledger(
                recs, wall_sec=time.perf_counter() - self._run_t0)
            if led is None:
                return
            net.metrics.emit("ledger", **led)
            mlog.info("ledger: " + ledgerlib.format_ledger(led))
        except Exception as e:  # noqa: BLE001 — telemetry only
            mlog.warn(f"ledger emit failed: {e}")

    # ---------------------------------------------------------------- tasks
    def _writes_output(self) -> bool:
        """True unless this process is a rank other than 0 of a mesh: of
        a mesh, rank 0 alone writes ``pred`` and the inference records
        (every rank holds every row)."""
        mesh = self.net.mesh
        return mesh is None or mesh.virtual or mesh.rank == 0

    def _output(self, mode: str):
        """``name_pred`` opened for writing with ``mode`` where this
        process writes it (:meth:`_writes_output`), else the null
        device."""
        path = self.name_pred if self._writes_output() else os.devnull
        return open(path, mode)  # disclint: ok(atomic-write)

    def _emit_latency_record(self, op: str) -> None:
        if not self._writes_output():
            return
        metrics = self.net.metrics
        h = metrics.histograms.get(f"{op}_latency_sec")
        s = h.summary() if h is not None else {"count": 0}
        if not s["count"]:
            return
        metrics.emit("latency", op=op, count=int(s["count"]),
                     **{k: round(s[k] * 1e3, 3)
                        for k in ("mean", "min", "max", "p50", "p95", "p99")},
                     unit="ms")

    def _pred_batches(self, what: str, staged: bool = False):
        """The pred iterator's batches, from the first (``staged``: through
        :meth:`_pred_source`); raises before any output file is opened
        when there is no pred section."""
        if self.itr_pred is None:
            raise RuntimeError(f"task = {self.task}: must specify a pred "
                               f"iterator section {what}")
        src = self._pred_source() if staged else self.itr_pred
        src.before_first()
        return iter(src.next, None)

    def _timed(self, op: str, fn, batch):
        """``fn(batch)``, a host array (so the device work is done), its
        time observed into the ``<op>_latency_sec`` histogram."""
        t0 = time.perf_counter()
        out = fn(batch)
        self.net.metrics.observe(f"{op}_latency_sec",
                                 time.perf_counter() - t0)
        return out

    def task_predict(self, raw: bool = False) -> None:
        """``task = pred``: one predicted class (or value) per valid row;
        ``raw`` (``task = pred_raw``): the final node's values of each,
        space-separated."""
        mlog.notice(f"start predicting{' raw scores' if raw else ''}...")
        fn = self.net.predict_raw if raw else self.net.predict
        try:
            batches = self._pred_batches("to predict", staged=True)
            with self._output("w") as fo:
                for batch in batches:
                    for row in self._timed("pred", fn, batch):
                        fo.write((" ".join(f"{v:g}" for v in row) if raw
                                  else f"{row:g}") + "\n")
        finally:
            self._close_prefetchers()
        self._emit_latency_record("pred")
        mlog.notice(f"finished prediction, write into {self.name_pred}")

    def task_extract(self) -> None:
        """``task = extract``: node ``extract_node_name``'s values of each
        valid row, as text rows or (``output_format = bin``) raw
        little-endian float32 rows; ``<pred>.meta`` holds the row
        width."""
        node = self.extract_node_name
        if not node:
            raise ValueError("task = extract: must set extract_node_name")
        mlog.notice(f"start extracting feature from node {node} ...")
        binary = self.output_format == 0
        wrote_meta = not self._writes_output()
        try:
            batches = self._pred_batches("to extract from", staged=True)
            with self._output("wb" if binary else "w") as fo:
                for batch in batches:
                    feat = self._timed(
                        "extract",
                        lambda b: self.net.extract_feature(b, node), batch)
                    if not wrote_meta:
                        with open(self.name_pred + ".meta", "w") as fm:  # disclint: ok(atomic-write)
                            fm.write(f"{feat.shape[1]}\n")
                        wrote_meta = True
                    if binary:
                        fo.write(np.ascontiguousarray(feat, "<f4").tobytes())
                    else:
                        for row in feat:
                            fo.write(" ".join(f"{v:g}" for v in row) + "\n")
        finally:
            self._close_prefetchers()
        self._emit_latency_record("extract")
        mlog.notice(f"finished extraction, write into {self.name_pred}")

    def task_serve(self) -> None:
        """``task = serve``: the loaded model behind the pinned-shape
        predict engine and the micro-batcher, the ``pred`` iterator
        replayed as a concurrent request stream: ``serve_clients``
        threads each submit single-row requests, which the batcher
        coalesces into bucket dispatches.  Predictions land in
        ``name_pred`` as ``task = pred`` writes them; the run emits a
        ``latency`` record (``op = serve``) and a ``serve`` record (QPS,
        dtype, buckets, the batcher's and the engine's accounting, the
        footprint and, after ``serve_calib``, the quantized variant's
        pairtest error).  ``serve_gen = 1`` goes to
        :meth:`task_serve_gen`."""
        assert self.itr_pred is not None, (
            "task=serve requires a 'pred = <out>' iterator section "
            "(the request stream)")
        from .serve import ServeConfig
        cfg = ServeConfig.from_pairs(self.cfg)
        if cfg.gen:
            return self.task_serve_gen(cfg)
        from .serve.engine import SERVE_TOL, PredictEngine
        from .serve.host import ModelHost, ServeModel
        metrics = self.net.metrics
        # built alike on every rank: a config it refuses fails them all
        # before any collective
        engine = PredictEngine(self.net, shapes=cfg.shapes, dtype=cfg.dtype,
                               metrics=metrics)
        if not self._writes_output():
            # a rank other than 0 of a mesh: every forward of rank 0's
            # engine is a collective dispatch this rank follows
            engine.follow()
            return
        host = ModelHost()
        stop_reporter = None
        try:
            sm = ServeModel(self.net, cfg, metrics=metrics, engine=engine)
            host.attach(sm, warmup=False)
            # the admin endpoint is up before warmup, so /readyz reads
            # 503 while the buckets warm
            admin = host.start_admin(
                metrics, port=cfg.admin_port,
                config=dataclasses.asdict(cfg)) if cfg.admin_port else None
            mlog.notice(f"serve: warming {len(cfg.shapes)} shape bucket(s) "
                        f"{list(cfg.shapes)}, dtype={cfg.dtype}, device "
                        f"{self.net.device} ...")
            sm.warmup()
            mlog.info(f"serve: warmup in {sm.engine.warmup_sec:.1f} sec")
            footprint = sm.footprint()
            metrics.set_gauge("serve_footprint_bytes",
                              footprint["total_bytes"])
            mlog.info(f"serve: model footprint "
                      f"{footprint['total_bytes'] / 1e6:.1f} MB "
                      f"(weights {footprint['weight_bytes'] / 1e6:.1f} MB, "
                      f"{footprint['buckets']} bucket(s))")
            if cfg.dtype != "f32" and cfg.calib > 0:
                # the quantized variant against f32 on the first
                # serve_calib request batches
                calib = []
                for batch in self._pred_batches("to calibrate on"):
                    calib.append(np.array(batch.data[:batch.batch_size
                                                     - batch.num_batch_padd],
                                          np.float32))
                    if len(calib) >= cfg.calib:
                        break
                if calib:
                    err = max(sm.engine.pairtest(r) for r in calib)
                    metrics.set_gauge("serve_quant_rel_err", err)
                    mlog.result(
                        f"serve: {cfg.dtype} pairtest vs f32 on "
                        f"{len(calib)} calibration batch(es): max rel err "
                        f"{err:.3g} (envelope {SERVE_TOL[cfg.dtype]:g})")
            bank, slo, flight = self._serve_watchers(sm, cfg, metrics)
            if admin is not None:
                admin.slo = slo
                admin.flight = flight
                # /statusz shows the last window even without sentinels
                sm.batcher.track_window = True
            if not host.mark_ready():
                mlog.warn("serve: host failed the ready admission check")
            if bank is not None or admin is not None:
                stop_reporter = self._start_serve_reporter(
                    sm, cfg, metrics, admin, bank, slo, flight)

            def rows():
                for batch in self._pred_batches("(the request stream)"):
                    valid = np.array(batch.data[:batch.batch_size
                                                - batch.num_batch_padd],
                                     np.float32)
                    for i in range(valid.shape[0]):
                        yield valid[i:i + 1]

            mlog.notice(f"serve: streaming requests over {cfg.clients} "
                        "client thread(s)")
            try:
                results, dur = self._stream_clients(
                    rows(), sm.predict, cfg.clients,
                    max(cfg.queue_depth, 2 * cfg.max_batch), "serve")
            except BaseException as e:
                if bank is not None:
                    bank.flight_dump("serve aborted: " + repr(e))
                raise
            with open(self.name_pred, "w") as fo:  # disclint: ok(atomic-write)
                for out in results:
                    row = out[0]
                    v = float(row.argmax()) if row.shape[0] > 1 \
                        else float(row[0])
                    fo.write(f"{v:g}\n")
            self._emit_latency_record("serve")
            metrics.set_gauge("serve_retraces", sm.retraces)
            stats = sm.batcher.stats()
            qps = len(results) / max(dur, 1e-9)
            quant = metrics.gauges.get("serve_quant_rel_err")
            self.last_serve = dict(stats, duration_sec=dur, qps=qps,
                                   dtype=cfg.dtype, retraces=sm.retraces,
                                   engine=sm.engine.stats(),
                                   quant_rel_err=quant)
            metrics.emit("serve", model=sm.name, duration_sec=round(dur, 3),
                         qps=round(qps, 1), dtype=cfg.dtype,
                         shapes=list(cfg.shapes), clients=cfg.clients,
                         retraces=sm.retraces, device=str(self.net.device),
                         engine=sm.engine.stats(), footprint=footprint,
                         **stats,
                         **({} if quant is None else {"quant_rel_err": quant}))
            if sm.retraces:
                mlog.warn(f"serve: {sm.retraces} dispatch(es) at a shape "
                          "warmup did not run")
            mlog.result(
                f"serve: {len(results)} requests in {dur:.2f} sec "
                f"({qps:.1f} req/s), {stats['batches']} dispatches (mean "
                f"batch {stats['mean_batch']}), retraces {sm.retraces}")
            if bank is not None and bank.anomalies:
                mlog.warn(f"serve: {len(bank.anomalies)} sentinel "
                          "anomaly(ies): see the anomaly records "
                          "(tools/obsv.py)")
        finally:
            if stop_reporter is not None:
                stop_reporter()
            # not ready first, then the batcher's drain, the admin last
            host.close()
            # the other ranks of a mesh follow until this stop
            engine.stop()
        mlog.notice(f"finished serving, wrote {self.name_pred}")

    def _serve_watchers(self, sm, cfg, metrics):
        """``(bank, slo, flight)`` of the micro-batched path: the serve
        sentinels (``serve_sentinel = 1`` with an active sink), the SLO
        tracker (``serve_slo_p99_ms`` > 0) and the flight capture that an
        anomaly or a burn arms; ``None`` where off.  Both ride the
        reporter's ``serve_window`` records."""
        if cfg.sentinel and not metrics.active:
            mlog.warn("serve_sentinel = 1 without an active metrics_sink: "
                      "serve_window/anomaly records have nowhere to land; "
                      "sentinels disarmed")
        if not (cfg.sentinel and metrics.active):
            if cfg.slo_p99_ms > 0.0:
                mlog.warn("serve_slo_p99_ms without serve_sentinel = 1 "
                          "(and an active metrics_sink): the SLO evaluates "
                          "over the sentinel reporter's serve_window "
                          "stream; targets ignored")
            return None, None, None
        from .monitor.sentinel import SentinelBank
        from .serve.admin import FlightCapture
        bank = SentinelBank(metrics, rel=self.sentinel_rel,
                            warmup=self.sentinel_warmup,
                            ring=self.sentinel_ring)
        sm.batcher.track_window = True
        flight = FlightCapture(
            metrics, lambda: sm.batcher.n_requests, model=sm.name,
            boost=cfg.flight_boost, requests=cfg.flight_requests,
            stats_fn=sm.batcher.stats)
        bank.on_anomaly = lambda hit: flight.trigger(
            f"anomaly: {hit['metric']} {hit['direction']} "
            f"{hit['rel_dev']:+.0%}")
        slo = None
        if cfg.slo_p99_ms > 0.0:
            from .monitor.slo import SloSpec, SloTracker
            sm.batcher.slo_ms = cfg.slo_p99_ms
            slo = SloTracker(
                SloSpec(p99_ms=cfg.slo_p99_ms, avail=cfg.slo_avail,
                        fast_sec=cfg.slo_fast_sec, slow_sec=cfg.slo_slow_sec,
                        fast_burn=cfg.slo_fast_burn,
                        slow_burn=cfg.slo_slow_burn),
                cfg.sentinel_window, metrics=metrics, model=sm.name,
                on_burn=lambda rec: flight.trigger(
                    f"slo: {rec['tier']} burn {rec['burn']:.1f} >= "
                    f"{rec['threshold']:g}"))
        return bank, slo, flight

    @staticmethod
    def _start_serve_reporter(sm, cfg, metrics, admin, bank, slo, flight):
        """Start the ``cxxnet-serve-sentinel`` thread: every
        ``serve_sentinel_window`` seconds it drains the batcher's window
        into one ``serve_window`` record (qps over the window's actual
        length) and hands it to the admin's cache, the sentinel bank,
        the SLO tracker and the flight capture.  Returns the function
        that stops it, after a last tick over the tail window."""
        stop = threading.Event()
        win = [0, time.perf_counter()]

        def tick():
            ws = sm.batcher.window_stats()
            now = time.perf_counter()
            dt, win[1] = max(now - win[1], 1e-6), now
            win[0] += 1
            rec = {"model": sm.name, "window": win[0],
                   "window_sec": round(dt, 3), "requests": ws["requests"],
                   "qps": round(ws["requests"] / dt, 2),
                   "queue_depth": ws["queue_depth"]}
            for k in ("viol", "p50_ms", "p95_ms", "p99_ms"):
                if k in ws:
                    rec[k] = ws[k]
            metrics.emit("serve_window", **rec)
            if admin is not None:
                admin.note_window(sm.name, rec)
            elif flight is not None:
                flight.note_window(rec)
            # an idle window too: a stalled dispatcher grows the queue
            # while nothing completes
            if bank is not None:
                bank.observe_serve(rec)
            if slo is not None:
                slo.observe(rec)
            if flight is not None:
                flight.tick()

        def run():
            try:
                while not stop.wait(cfg.sentinel_window):
                    tick()
                tick()
            except BaseException as e:  # noqa: BLE001 — must surface
                mlog.warn(f"serve sentinel reporter died: {e!r}; "
                          "serve_window records stop here")

        th = threading.Thread(target=run, daemon=True,
                              name="cxxnet-serve-sentinel")
        th.start()

        def stop_reporter():
            stop.set()
            th.join()
        return stop_reporter

    @staticmethod
    def _stream_clients(items, call, clients: int, depth: int, name: str):
        """Feed ``items`` through a bounded work queue to ``clients``
        threads (named ``cxxnet-<name>-client-<j>``), each calling
        ``call(item)``; returns the results in item order and the wall
        seconds.  The first client or producer
        exception stops the stream and is raised."""
        results: dict = {}
        errors: List[BaseException] = []
        abort = threading.Event()
        work: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        n_total = [0]

        def put(item) -> bool:
            while not abort.is_set():
                try:
                    work.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                idx = 0
                for item in items:
                    if not put((idx, item)):
                        return
                    idx += 1
                n_total[0] = idx
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
                abort.set()
            finally:
                for _ in range(clients):
                    if not put(done):
                        return

        def client():
            while True:
                try:
                    item = work.get(timeout=0.05)
                except queue.Empty:
                    if abort.is_set():
                        return
                    continue
                if item is done:
                    return
                i, x = item
                try:
                    results[i] = call(x)
                except BaseException as e:  # noqa: BLE001 — reported
                    errors.append(e)
                    abort.set()
                    return

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, daemon=True,
                                    name=f"cxxnet-{name}-client-{j}")
                   for j in range(clients)]
        prod = threading.Thread(target=producer, daemon=True,
                                name=f"cxxnet-{name}-producer")
        prod.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        prod.join()
        dur = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return [results[i] for i in range(n_total[0])], dur

    @staticmethod
    def _prompts(batch, cfg) -> List[np.ndarray]:
        """The requests of one pred-iterator batch: each valid row's
        leading ``serve_gen_prompt`` ids, or under
        ``serve_gen_prompt_doc = 1`` each document of the row (by the
        ``packseq`` segment field), capped at ``serve_gen_prompt``."""
        n = batch.batch_size - batch.num_batch_padd
        rows = np.asarray(batch.data[:n], np.float32).reshape(n, -1)
        if not cfg.gen_prompt_doc:
            return [r[:cfg.gen_prompt].astype(np.int32) for r in rows]
        s = rows.shape[1]
        label = None if batch.label is None else np.asarray(batch.label)
        if label is None or label.shape[-1] != 3 * s:
            raise ValueError("serve_gen_prompt_doc = 1 needs the packseq "
                             "iterator's segment field in the pred rows")
        out = []
        for row, seg in zip(rows, label[:n, s:2 * s]):
            for k in range(1, int(seg.max()) + 1):
                out.append(row[seg == k][:cfg.gen_prompt].astype(np.int32))
        return out

    def task_serve_gen(self, cfg) -> None:
        """Autoregressive generation: each valid pred-iterator row's
        leading ``serve_gen_prompt`` ids (or each of its documents, see
        :meth:`_prompts`) become one request,
        ``serve_clients`` threads submit them concurrently, and the step
        scheduler keeps the ``decode_slots`` batch full, speculatively
        with a ``serve_draft_model`` and ``spec_k >= 1``.  Generated ids
        land in ``name_pred``, space-separated, one request per line."""
        from .serve.host import GenModel, ModelHost, load_draft_trainer
        metrics = self.net.metrics
        if cfg.spec_k >= 1 and not cfg.draft_model:
            raise ValueError(f"spec_k = {cfg.spec_k} without "
                             "serve_draft_model: speculation needs a draft "
                             "snapshot")
        draft = None
        if cfg.draft_model:
            if cfg.spec_k >= 1:
                mlog.notice(f"serve: loading draft model {cfg.draft_model} "
                            f"(speculative decoding, spec_k = {cfg.spec_k})")
                draft = load_draft_trainer(self.cfg, cfg.draft_model)
            else:
                mlog.warn("serve: serve_draft_model set but spec_k = 0 — "
                          "speculation stays off")
        host = ModelHost()
        try:
            gm = host.attach(GenModel(self.net, cfg, draft_trainer=draft,
                                      metrics=metrics), warmup=False)
            # the admin endpoint only: the generation path has no
            # reporter, so /statusz shows the scheduler's live counters
            if cfg.admin_port:
                host.start_admin(metrics, port=cfg.admin_port,
                                 config=dataclasses.asdict(cfg))
            mlog.notice(f"serve: warming decode engine ({cfg.slots} "
                        f"slot(s), max_seqlen {gm.engine.max_seqlen}, block "
                        f"widths {list(gm.engine.block_widths)}, KV cache "
                        f"{gm.engine.kv_dtype}, device {self.net.device}) "
                        "...")
            gm.warmup()
            mlog.info(f"serve: decode warmup in "
                      f"{gm.engine.warmup_sec:.1f} sec")
            if not host.mark_ready():
                mlog.warn("serve: host failed the ready admission check")
            footprint = gm.footprint()
            metrics.set_gauge("serve_footprint_bytes",
                              footprint["total_bytes"])

            def prompts():
                for batch in self._pred_batches("(the prompt stream)"):
                    yield from self._prompts(batch, cfg)

            mlog.notice(f"serve: streaming generation over {cfg.clients} "
                        "client thread(s)")
            results, dur = self._stream_clients(
                prompts(), gm.generate, cfg.clients, cfg.queue_depth,
                "serve-gen")
            with open(self.name_pred, "w") as fo:  # disclint: ok(atomic-write)
                for toks in results:
                    fo.write(" ".join(str(t) for t in toks) + "\n")
            self._emit_latency_record("token")
            self._emit_latency_record("gen")
            metrics.set_gauge("serve_retraces", gm.retraces)
            stats = gm.scheduler.stats()
            tps = stats["tokens"] / max(dur, 1e-9)
            calls = {"prefill_calls": gm.engine.prefill_calls,
                     "step_calls": gm.engine.step_calls,
                     "block_calls": gm.engine.block_calls}
            if gm.draft is not None:
                calls.update(draft_prefill_calls=gm.draft.prefill_calls,
                             draft_step_calls=gm.draft.step_calls)
            self.last_serve = dict(stats, duration_sec=dur,
                                   tokens_per_sec=tps,
                                   retraces=gm.retraces, **calls)
            metrics.emit("serve_gen", model=gm.name,
                         duration_sec=round(dur, 3),
                         tokens_per_sec=round(tps, 1), slots=cfg.slots,
                         max_seqlen=gm.engine.max_seqlen,
                         gen_tokens=cfg.gen_tokens, clients=cfg.clients,
                         sample=cfg.gen_sample, retraces=gm.retraces,
                         kv_dtype=gm.engine.kv_dtype,
                         device=str(self.net.device), footprint=footprint,
                         **calls, **stats)
            if gm.retraces:
                mlog.warn(f"serve: {gm.retraces} block dispatch(es) at a "
                          "width warmup did not run")
            spec_note = (
                f", acceptance {stats['acceptance_rate']:.0%} over "
                f"{stats['verify_calls']} verify dispatch(es)"
                if "acceptance_rate" in stats else "")
            mlog.result(
                f"serve: generated {stats['tokens']} tokens for "
                f"{len(results)} requests in {dur:.2f} sec ({tps:.1f} "
                f"tok/s, mean occupancy {stats['mean_occupancy']}, "
                f"{stats['batching']} batching{spec_note}), retraces "
                f"{gm.retraces}")
        finally:
            host.close()
            if draft is not None:
                draft.metrics.close()
        mlog.notice(f"finished serving, wrote {self.name_pred}")

    def task_check(self, path: str) -> int:
        """``task = check``: the config lint and the device-free traced
        pass (``analysis.run_check``); each finding printed, a summary
        line, one ``check`` record in the sink (and no ``run`` header).
        Returns 1 iff a finding is an error."""
        from .analysis import run_check
        from .monitor.metrics import Metrics
        findings, code = run_check(self.cfg, path=path)
        self.last_check = findings
        counts = {"error": 0, "warn": 0, "info": 0}
        for f in findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
            emit = mlog.result if f.severity in ("error", "warn") \
                else mlog.info
            emit("check: " + f.format())
        mlog.result(
            f"check: {path or '<config>'}: {counts['error']} error(s), "
            f"{counts['warn']} warning(s), {counts['info']} info")
        metrics = Metrics()
        for k, v in self.cfg:
            if k == "metrics_sink":
                metrics.configure_sink(v)
        metrics.emit("check", config=path, n_error=counts["error"],
                     n_warn=counts["warn"], n_info=counts["info"],
                     findings=[f.to_dict() for f in findings])
        metrics.close()
        return code

    def _join_distributed(self, ids: List[int]) -> bool:
        """Bring up the data mesh's process group, if the run has one:
        join an external group (``CXN_COORDINATOR`` / ``CXN_NUM_PROC`` /
        ``CXN_PROC_RANK``, else the ``dist_*`` keys), setting the
        iterators' ``dist_num_worker`` / ``dist_worker_rank`` unless the
        config does; inside a spawned rank, take its rank.  Returns True
        when this process must instead spawn one rank a device of a
        ``dev`` with several ids (their count checked first)."""
        import torch.distributed as dist
        cfg = dict(self.cfg)
        if dist.is_initialized():
            self.quiet_rank = dist.get_rank() != 0
            if self.quiet_rank:
                mlog.mute()
        else:
            coord = os.environ.get("CXN_COORDINATOR",
                                   cfg.get("dist_coordinator", ""))
            if not coord:
                if len(ids) > 1:
                    meshlib.select_devices(cfg["dev"])
                    return True
                return False
            nproc = int(os.environ.get("CXN_NUM_PROC",
                                       cfg.get("dist_num_proc", "1")))
            rank = int(os.environ.get("CXN_PROC_RANK",
                                      cfg.get("dist_proc_rank", "0")))
            platform = meshlib.parse_device_spec(
                cfg.get("dev", "gpu").lower())["platform"]
            meshlib.init_distributed(
                coord, nproc, rank,
                backend="gloo" if platform == "cpu" else "nccl")
            if "dist_num_worker" not in cfg:
                self.set_param("dist_num_worker", str(nproc))
                self.set_param("dist_worker_rank", str(rank))
            mlog.info(f"distributed: rank {rank}/{nproc} via {coord}")
        return False

    def _spawn_ranks(self, argv: List[str], n: int) -> int:
        """Run this command as ``n`` ranks (one a device of ``dev``),
        rendezvous on a private file store; a rank that fails fails the
        command, and the others are stopped."""
        dev = dict(self.cfg)["dev"]
        device = meshlib.select_devices(dev)[0]
        backend = meshlib.backend_for(device)
        mlog.info(f"dev = {dev}: {n} ranks over {backend}")
        # CPU ranks split the host's cores instead of each taking all
        threads = max(1, torch.get_num_threads() // n) \
            if device.type == "cpu" else 0
        meshlib.spawn(_cli_rank, n, (list(argv), threads), backend=backend)
        return 0

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            mlog.notice("Usage: python -m cxxnet_tpu_torch <config> "
                        "[key=value ...]")
            return 0
        # the ledger's wall starts here: init, iterators and the first
        # dispatch are part of the run it accounts for
        self._run_t0 = time.perf_counter()
        for k, v in parse_config_file(argv[0]):
            self.set_param(k, v)
        for k, v in parse_keyval_args(argv[1:]):
            self.set_param(k, v)
        # the sink appends: the ledger folds from where this session began
        spec = dict(self.cfg).get("metrics_sink", "")
        if spec.startswith("jsonl:"):
            try:
                self._sink_offset = os.path.getsize(spec[len("jsonl:"):])
            except OSError:
                self._sink_offset = 0
        if self.task not in PORTED_TASKS:
            raise NotImplementedError(
                f"task = {self.task} is not ported to cxxnet_tpu_torch yet "
                f"(ported: {', '.join(PORTED_TASKS)}; ROADMAP.md)")
        if self.task == "check":
            # lint only: no iterators, no device, no data files; what the
            # port refuses below is one of its findings
            return self.task_check(argv[0])
        ids = meshlib.parse_device_spec(
            dict(self.cfg).get("dev", "gpu").lower())["ids"] or []
        if self._join_distributed(ids):
            return self._spawn_ranks(argv, len(ids))
        try:
            self.init()
            mlog.info("initializing end, start working")
            if self.task in ("train", "finetune"):
                self.task_train()
            elif self.task in ("pred", "pred_raw"):
                self.task_predict(raw=self.task == "pred_raw")
            elif self.task == "extract":
                self.task_extract()
            else:
                self.task_serve()
        finally:
            # each close guarded: the broken iterator that aborted the task
            # often fails its close too, and that must neither mask the
            # first exception nor keep the closes after it from running
            try:
                self._close_prefetchers()
            except Exception as e:  # noqa: BLE001
                mlog.warn(f"prefetcher close failed: {e}")
            for it in [self.itr_train, self.itr_pred] + self.itr_evals:
                if it is not None:
                    try:
                        it.close()
                    except Exception as e:  # noqa: BLE001
                        mlog.warn(f"iterator close failed: {e}")  # disclint: ok(warn-once)
            # the ledger is the stream's last record, after the task's own
            # (a flight dump included)
            self._emit_ledger()
            if self.net is not None:
                self.net.metrics.close()
        return 0


def main() -> int:
    return LearnTask().run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())

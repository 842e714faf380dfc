"""The port's training observability plane against the JAX package, on
the CPU (doc/monitor.md).

* The record schema: tests/test_monitor.py's MLP conf through both CLIs
  at ``monitor = 1 monitor_interval = 2``, both from one JAX-written
  ``0000.model``: the same kinds in the same order, the same key set per
  record, the same ``monitor`` layer names, and norms within 1e-5
  relative (float32).  The repo's own ``tools/obsv.py`` renders the
  port's sink and ``--diff``s it against the JAX run (a verdict, never
  "unreadable").
* The NaN / inf loss guard under ``monitor_nan = warn`` and ``fatal``,
  record for record the JAX package's.
* ``rollback``: a NaN-poisoned batch of round 3 rolls back to the round-2
  snapshot once (``retry`` 1, ``restored_round`` 2) and the run
  completes; with every pass poisoned the exception goes on once the
  retries run out; and a run continued from a snapshot the retried run
  wrote equals the retried run bitwise (the reseeded generator state is
  in the snapshot).
* The pure folds (``build_ledger``, ``SentinelBank``, ``diff_runs``) fed
  the same record streams in both packages give equal outputs.
* A CPU profile window: ``trace`` and ``layer_profile`` records, every
  connection's scope named, backward time booked through the autograd
  sequence numbers; the trace reader's collective and lost-event rules
  on synthetic events.
* Nothing when off: at ``monitor = 0`` and no ``prof`` an update enters
  no per-connection profiler range and runs no norm code.
* The cost and memory records: ``layer_profile`` rows carry the JAX
  package's cost columns (``mfu_pct`` / ``roofline_*`` only with the
  card's peaks); ``mem_table`` over a scripted allocator gives the JAX
  payload's keys; a CLI run's ``mem_profile`` record (the probe patched
  in on the CPU) reads in tools/obsv.py and the port's monitor/diff.py.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import cxxnet_tpu_torch.ckpt as ckptlib  # noqa: E402
from cxxnet_tpu_torch.io.data import IIterator  # noqa: E402
from cxxnet_tpu_torch.main import LearnTask  # noqa: E402
from cxxnet_tpu_torch.monitor import TrainingDiverged  # noqa: E402
from test_ckpt import _write_conf as _ckpt_conf  # noqa: E402
from test_ckpt import _write_synth_mnist as _ckpt_mnist  # noqa: E402
from test_main import MLP_NET, _write_synth_mnist  # noqa: E402
from test_monitor import TINY_MLP  # noqa: E402

MONITOR_TOL = 1e-5


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _golden_conf(tmp_path, name, extra=""):
    """tests/test_monitor.py's ``_run_cli`` conf (the MLP over 64
    synthetic MNIST images, batch 16, an eval section, 2 rounds), from
    the shared ``0000.model``."""
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"""
dev = cpu
data = train
iter = mnist
  path_img = {tmp_path}/img.gz
  path_label = {tmp_path}/lbl.gz
iter = end
eval = val
iter = mnist
  path_img = {tmp_path}/img.gz
  path_label = {tmp_path}/lbl.gz
iter = end
{MLP_NET}
input_shape = 1,1,144
batch_size = 16
eta = 0.05
num_round = 2
metric = error
model_in = {tmp_path}/0000.model
model_dir = {tmp_path}/models_{name}
save_model = 0
silent = 1
print_step = 2
metrics_sink = jsonl:{tmp_path}/{name}.jsonl
{extra}
""")
    return str(conf)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Both CLIs over the golden conf at monitor = 1 monitor_interval =
    2, from one JAX-initialised snapshot; returns the tmp dir."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu.main import LearnTask as JTask
    tmp = tmp_path_factory.mktemp("golden")
    _write_synth_mnist(tmp, n=64)
    _make_trainer(MLP_NET, 16, "cpu", extra=[
        ("input_shape", "1,1,144"), ("eta", "0.05")]).save_model(
            str(tmp / "0000.model"))
    for name, task in (("jax", JTask), ("port", LearnTask)):
        assert task().run([_golden_conf(
            tmp, name, "monitor = 1\nmonitor_interval = 2\n")]) == 0
    return tmp


def test_jsonl_schema_golden_matches_jax(golden):
    jax_recs = _records(golden / "jax.jsonl")
    port = _records(golden / "port.jsonl")
    assert {r["kind"] for r in port} == {"run", "compile", "step", "round",
                                         "monitor", "ledger"}
    assert [r["kind"] for r in port] == [r["kind"] for r in jax_recs]
    for a, b in zip(jax_recs, port):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
    assert port[-1]["kind"] == "ledger" and port[-1]["source"] == "run"
    run = port[0]
    assert run["updater"] == "sgd" and run["batch_size"] == 16
    assert "pool_bwd" in run["engine_opts"]
    mon = {(r["step"], r["layer"]): r for r in port if r["kind"] == "monitor"}
    jmon = {(r["step"], r["layer"]): r for r in jax_recs
            if r["kind"] == "monitor"}
    assert mon.keys() == jmon.keys()
    assert {layer for _, layer in mon} == {
        "00-fc1/wmat", "00-fc1/bias", "02-fc2/wmat", "02-fc2/bias"}
    for key, r in mon.items():
        for f in ("w_norm", "g_norm", "u_norm", "u_ratio"):
            np.testing.assert_allclose(r[f], jmon[key][f], rtol=MONITOR_TOL,
                                       err_msg=f"{key} {f}")
    # 64 images / batch 16: 4 steps a round, a tick every 2 steps
    assert len(mon) == 4 * 4
    rounds = [r for r in port if r["kind"] == "round"]
    assert rounds[0]["train_step_traces"] == 1
    assert "hbm_peak_bytes" not in rounds[0]   # absent on the CPU


def test_obsv_renders_and_diffs_port_sink(golden):
    """tools/obsv.py, unedited, renders the port's sink (exit 0) and
    --diffs it against the JAX run: a verdict (0 or 1), never 2."""
    obsv = os.path.join(REPO, "tools", "obsv.py")
    r = subprocess.run([sys.executable, obsv, str(golden / "port.jsonl")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "goodput" in r.stdout and "throughput" in r.stdout
    r = subprocess.run([sys.executable, obsv, "--diff",
                        str(golden / "jax.jsonl"), str(golden / "port.jsonl")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode in (0, 1), r.stdout + r.stderr
    assert "verdict" in r.stdout


@pytest.mark.parametrize("fold", ["build_ledger", "sentinel_bank",
                                  "diff_runs"])
def test_pure_folds_match_jax(golden, tmp_path, fold):
    """The ledger, the sentinels and the run comparator, fed one record
    stream (the golden runs' own), give equal outputs in both
    packages."""
    from cxxnet_tpu.monitor import diff as jdiff, ledger as jledger
    from cxxnet_tpu.monitor.metrics import MetricsRegistry
    from cxxnet_tpu.monitor.sentinel import SentinelBank as JBank
    from cxxnet_tpu_torch.monitor import diff as tdiff, ledger as tledger
    from cxxnet_tpu_torch.monitor.metrics import Metrics
    from cxxnet_tpu_torch.monitor.sentinel import SentinelBank as TBank
    a, b = _records(golden / "jax.jsonl"), _records(golden / "port.jsonl")
    if fold == "build_ledger":
        for recs in (a, b):
            assert jledger.build_ledger(recs, wall_sec=1.0) \
                == tledger.build_ledger(recs, wall_sec=1.0)
            assert jledger.build_ledger(recs, source="posthoc") \
                == tledger.build_ledger(recs, source="posthoc")
    elif fold == "diff_runs":
        for x, y in ((a, b), (b, a), (a, a)):
            assert jdiff.diff_runs(x, y) == tdiff.diff_runs(x, y)
    else:
        outs = []
        for reg, bank_t in ((MetricsRegistry(), JBank), (Metrics(), TBank)):
            sink = tmp_path / f"{bank_t.__module__}.jsonl"
            reg.configure_sink(f"jsonl:{sink}")
            bank = bank_t(reg, rel=0.2, warmup=2, ring=4)
            rate = 100.0
            for i, r in enumerate(x for x in a if x["kind"] == "step"):
                # a throughput series with a drop past the warmup
                rate = 40.0 if i == 3 else 100.0
                bank.observe_step(dict(r, examples_per_sec=rate))
            bank.observe_round({"round": 1, "hbm_peak_bytes": 1 << 20})
            bank.flight_dump("end")
            reg.close()
            outs.append(([{k: v for k, v in r.items() if k != "ts"}
                          for r in _records(sink)], bank.state()))
        assert outs[0] == outs[1]
        assert any(r["kind"] == "anomaly" for r in outs[1][0])


def test_sentinel_skips_windows_of_the_planes_own_work(golden, tmp_path,
                                                     monkeypatch):
    """print_step = 1 under monitor_interval = 2 and a one-dispatch
    profile window: the windows holding a monitor tick or the profiled
    dispatch (the profiler's start, the trace's export and reports)
    still enter the flight ring, but the throughput sentinel judges only
    the others, so the plane's own cost does not read as a regression
    (on the card, chip_smoke.py's ``observe`` requires no anomaly from a
    healthy run; CPU step times are too noisy to require it here)."""
    from cxxnet_tpu_torch.monitor.sentinel import SentinelBank
    seen = []
    orig = SentinelBank.observe_step

    def spy(self, rec, judge=True):
        seen.append((rec["global_step"], judge))
        return orig(self, rec, judge)

    monkeypatch.setattr(SentinelBank, "observe_step", spy)
    sink = tmp_path / "s.jsonl"
    task = LearnTask()
    assert task.run([_golden_conf(golden, "sentinel_judge"),
                     "monitor=1", "monitor_interval=2", "print_step=1",
                     "sentinel=1",
                     f"prof={tmp_path}/prof", "prof_start_step=4",
                     "prof_num_steps=1", f"metrics_sink=jsonl:{sink}"]) == 0
    # ticks at global steps 2, 4, 6, 8; the window profiles step 5
    assert seen == [(1, True), (2, False), (3, True), (4, False),
                    (5, False), (6, False), (7, True), (8, False)]
    assert "trace" in [r["kind"] for r in _records(sink)]


# ------------------------------------------------------------ NaN guard

def _port_trainer(net, batch, extra=()):
    """A port trainer on ``net`` (conf text) at ``dev = cpu``."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(net) + [
            ("batch_size", str(batch)), ("dev", "cpu")] + list(extra):
        t.set_param(k, v)
    t.init_model()
    return t


def _nan_batch(n=16, d=12, nan=True):
    from cxxnet_tpu.io.data import DataBatch
    rnd = np.random.RandomState(0)
    data = rnd.rand(n, 1, 1, d).astype(np.float32)
    if nan:
        data[0, 0, 0, 0] = np.nan
    return DataBatch(data=data,
                     label=rnd.randint(0, 4, (n, 1)).astype(np.float32),
                     index=np.arange(n, dtype=np.uint32))


@pytest.mark.parametrize("action", ["warn", "fatal"])
def test_nan_guard_matches_jax(tmp_path, action, capsys):
    """A NaN batch at a monitor tick: both packages emit the same ``nan``
    record; ``warn`` warns and goes on, ``fatal`` raises
    TrainingDiverged (the JAX package's class under each)."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu.monitor import TrainingDiverged as JDiverged
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    keys = [("monitor", "1"), ("monitor_interval", "1"),
            ("monitor_nan", action)]
    recs = {}
    for pkg in ("jax", "port"):
        sink = tmp_path / f"{pkg}.jsonl"
        extra = keys + [("metrics_sink", f"jsonl:{sink}")]
        if pkg == "jax":
            t = _make_trainer(TINY_MLP, 16, "cpu:0", extra=extra)
            err = JDiverged
        else:
            t = _port_trainer(TINY_MLP, 16, extra)
            err = TrainingDiverged
        t.start_round(1)
        if action == "fatal":
            with pytest.raises(err, match="non-finite loss"):
                t.update(_nan_batch())
        else:
            t.update(_nan_batch())
        t.metrics.close()
        recs[pkg] = [{k: v for k, v in r.items() if k != "ts"}
                     for r in _records(sink) if r["kind"] == "nan"]
    assert len(recs["port"]) == 1
    assert set(recs["port"][0]) == set(recs["jax"][0])
    for f in ("step", "round", "action"):
        assert recs["port"][0][f] == recs["jax"][0][f]
    assert not np.isfinite(recs["port"][0]["loss"])
    if action == "warn":
        assert "non-finite loss" in capsys.readouterr().err


# ------------------------------------------------------------- rollback

class _Poison(IIterator):
    """NaN-poisons the ``at``-th batch it yields (counted across rounds),
    once, or every ``at``-th when ``every``: the divergence injection of
    tests/test_ckpt.py.  Its state is its base's."""

    def __init__(self, base, at, every=False):
        self.base = base
        self.at = at
        self.every = every
        self.count = 0
        self.fired = False

    def before_first(self):
        self.base.before_first()

    def next(self):
        b = self.base.next()
        if b is None:
            return None
        self.count += 1
        hit = (self.count % self.at == 0) if self.every \
            else (not self.fired and self.count == self.at)
        if hit:
            self.fired = True
            b = dataclasses.replace(b, data=np.full_like(b.data, np.nan))
        return b

    def state(self):
        return self.base.state()

    def set_state(self, st):
        self.base.set_state(st)

    def close(self):
        self.base.close()


def _rollback_task(conf, *args, poison=None, every=False):
    from cxxnet_tpu_torch.utils.config import (parse_config_file,
                                               parse_keyval_args)
    task = LearnTask()
    # the ledger's wall starts where run() would start it
    task._run_t0 = time.perf_counter()
    for k, v in parse_config_file(str(conf)) + parse_keyval_args(list(args)):
        task.set_param(k, v)
    task.init()
    if poison is not None:
        task.itr_train = _Poison(task.itr_train, poison, every)
    return task


def _finish(task):
    try:
        task.task_train()
    finally:
        task._emit_ledger()
        task.net.metrics.close()
        for it in [task.itr_train] + task.itr_evals:
            it.close()


def _flat(path):
    from cxxnet_tpu_torch.nnet.trainer import read_snapshot
    header, params, buffers, opt, _ = read_snapshot(path)
    flat = {}
    for name, tree in (("params", params), ("opt", opt or {})):
        for k, g in tree.items():
            for t, st in g.items():
                for n, a in (st.items() if isinstance(st, dict)
                             else [("", st)]):
                    flat[f"{name}/{k}/{t}/{n}"] = np.asarray(a).tobytes()
    return header["extra"], flat


def test_rollback_recovers_and_resumes_exactly(tmp_path):
    """tests/test_ckpt.py's rollback run in the port: the MLP with dropout
    and momentum, 8 batches a round, ``ckpt_async = 1``, monitor_nan =
    fatal, rollback = 2, batch 3 of round 3 NaN-poisoned once.  One
    ``rollback`` record (retry 1, restored_round 2) after the ``nan``
    record, the run completes with finite losses, its last snapshot
    validates, and the ledger counts the rollback.  Under ``trace_sample
    = 1`` the writer's spans of the snapshots after the rollback land in
    the sink (the rolled-back trainer's metrics are closed).  A run
    continued from the retried run's round-3 snapshot ends bitwise equal
    to it."""
    _ckpt_mnist(tmp_path)
    sink = tmp_path / "m.jsonl"
    conf = _ckpt_conf(tmp_path, str(tmp_path / "R"), extra=f"""num_round = 5
monitor = 1
monitor_interval = 1
monitor_nan = fatal
rollback = 2
ckpt_keep = 5
trace_sample = 1
metrics_sink = jsonl:{sink}
""")
    task = _rollback_task(conf, poison=2 * 8 + 3)
    _finish(task)
    assert ckptlib.validate_snapshot(str(tmp_path / "R" / "0005.ckpt"))
    recs = _records(sink)
    kinds = [r["kind"] for r in recs]
    (rb,) = [r for r in recs if r["kind"] == "rollback"]
    assert rb["retry"] == 1 and rb["max_retry"] == 2
    assert rb["restored_round"] == 2 and rb["from_round"] == 3
    assert "TrainingDiverged" in rb["reason"]
    assert kinds.index("nan") < kinds.index("rollback")
    assert kinds[-1] == "ledger" and recs[-1]["rollbacks"] == 1
    assert task.net.metrics.counters.get("rollbacks") == 1
    after = recs[kinds.index("rollback"):]
    writes = [r for r in after if r["kind"] == "span"
              and r["span"] in ("ckpt_shard", "ckpt_manifest", "ckpt_prune")]
    assert {r["span"] for r in writes} == {"ckpt_shard", "ckpt_manifest",
                                           "ckpt_prune"}
    # one manifest a snapshot of rounds 3-5
    assert sum(r["span"] == "ckpt_manifest" for r in writes) == \
        sum(r["kind"] == "ckpt" for r in after) == 3
    # the poisoned step raised before its loss was kept: rounds 1-2, two
    # steps of the dying round, the retried rounds 3-5
    losses = task.last_train["losses"]
    assert len(losses) == 16 + 2 + 24 and np.isfinite(losses).all()
    # continue from the retried run's round-3 snapshot: the same end
    cont = tmp_path / "C"
    cont.mkdir()
    for n in ("0002.ckpt", "0003.ckpt"):
        shutil.copytree(tmp_path / "R" / n, cont / n)
    _finish(_rollback_task(conf, "continue=1", f"model_dir={cont}",
                           "metrics_sink=none"))
    ea, fa = _flat(str(tmp_path / "R" / "0005.ckpt"))
    eb, fb = _flat(str(cont / "0005.ckpt"))
    assert fa.keys() == fb.keys()
    assert [k for k in fa if fa[k] != fb[k]] == []
    assert ea["train_state"] == eb["train_state"]
    # the retried rounds drew from the reseeded stream
    seed_state = torch.Generator().manual_seed(0).get_state()
    assert ea["train_state"]["torch_rng_state"] != \
        seed_state.numpy().tobytes().hex()


def test_rollback_reraises_when_retries_run_out(tmp_path):
    """Every 8th batch poisoned (one a round): rollback = 1 restores once,
    the retried round diverges again and TrainingDiverged goes on."""
    _ckpt_mnist(tmp_path)
    sink = tmp_path / "m.jsonl"
    conf = _ckpt_conf(tmp_path, str(tmp_path / "R2"), extra=f"""num_round = 4
monitor = 1
monitor_interval = 1
monitor_nan = fatal
rollback = 1
metrics_sink = jsonl:{sink}
""")
    task = _rollback_task(conf, poison=8, every=True)
    with pytest.raises(TrainingDiverged):
        _finish(task)
    recs = _records(sink)
    assert [r["retry"] for r in recs if r["kind"] == "rollback"] == [1]
    assert recs[-1]["kind"] == "ledger" and recs[-1]["rollbacks"] == 1
    assert any(r["kind"] == "nan" for r in recs)


def test_reseed_rng_is_deterministic():
    """reseed_rng folds a salt into the generator's state: the same salt
    gives the same stream, another salt another, and the state moved."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    states = []
    for salt in (1, 1, 2):
        t = NetTrainer()
        t.rng = torch.Generator().manual_seed(7)
        t.reseed_rng(salt)
        states.append(torch.rand(4, generator=t.rng))
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], states[2])
    assert not torch.equal(states[0],
                           torch.rand(4, generator=torch.Generator()
                                      .manual_seed(7)))


# ------------------------------------------------------ profile windows

def test_cpu_profile_window_names_every_scope(golden, tmp_path):
    """prof over dispatches 1-2 of the golden conf on the CPU: one
    ``trace`` record (2 steps, a device time, no collectives) and one
    ``layer_profile`` naming every connection's scope, each
    parameterised layer with backward time, and nearly all op time
    attributed; the window's trace holds the per-connection ranges."""
    from cxxnet_tpu_torch.monitor import trace
    sink = tmp_path / "p.jsonl"
    task = LearnTask()
    assert task.run([_golden_conf(golden, "prof"), "num_round=1",
                     f"metrics_sink=jsonl:{sink}", f"prof={tmp_path}/prof",
                     "prof_start_step=1", "prof_num_steps=2"]) == 0
    recs = _records(sink)
    (tr,) = [r for r in recs if r["kind"] == "trace"]
    (lp,) = [r for r in recs if r["kind"] == "layer_profile"]
    assert tr["steps"] == 2 and tr["device_sec"] > 0
    assert tr["comm_sec"] == 0 and tr["comm_by_kind"] == {}
    rows = {r["layer"]: r for r in lp["rows"]}
    scopes = ["00-fc1", "01-relu", "02-fc2", "03-softmax"]
    assert task.net.layer_scopes() == scopes
    assert set(scopes) <= set(rows)
    for s in ("00-fc1", "02-fc2"):
        assert 0 < rows[s]["bwd_ms"] < rows[s]["device_ms"], rows[s]
    assert lp["coverage"] > 0.5
    events = trace.load_trace(task.prof_window.last_trace)
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(scopes) <= names
    assert sum(task.prof_window.last_launches.values()) == 0
    assert task.last_trace_report["lost_events"] == 0
    assert task.last_trace_report["short"] == {}


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


def test_trace_reader_collectives_and_lost_events():
    """The reader on synthetic device events: the busy union per step,
    NCCL kernels by family with the share compute covers, and the lost
    events of a window, kernel by kernel."""
    from cxxnet_tpu_torch.monitor import trace
    evs = [_ev("kernel", "void flash_fwd_wgmma_kernel<64, true>(...)", 0, 10),
           _ev("kernel", "ampere_bf16_gemm", 5, 10),
           _ev("kernel", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 12, 8),
           _ev("gpu_memcpy", "Memcpy HtoD", 30, 2)]
    rep = trace.comm_report_in(evs, steps=2)
    assert rep["device_sec"] == pytest.approx(22e-6 / 2)
    assert rep["comm_sec"] == pytest.approx(8e-6 / 2)
    assert rep["overlap_frac"] == pytest.approx(3 / 8, abs=1e-4)
    assert set(rep["comm_by_kind"]) == {"all-reduce"}
    assert trace.collective_kind("ncclKernel_AllGather_RING") == "all-gather"
    assert trace.collective_kind("flash_fwd_kernel") is None
    assert trace.kernel_base("void (anonymous namespace)::lnb_reg_kernel"
                             "<__nv_bfloat16, false, 8, 8>(float*)") \
        == "lnb_reg_kernel"
    assert trace.kernel_shortfall(evs, {"flash_attention_fwd": 1}) == {}
    assert trace.kernel_shortfall(evs, {"flash_attention_fwd": 3}) == {
        "flash_fwd_kernel|flash_fwd_wgmma_kernel": (3, 1)}


def test_window_events_keep_what_the_range_launched():
    """The reader cuts a trace to the window's range: a device event
    stays when the host call that launched it lies inside the range
    (though the kernel itself ran past it), the warm-up burst's kernels
    before the range go, and a trace without the range stays whole."""
    from cxxnet_tpu_torch.monitor import trace
    evs = [_ev("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
           _ev("kernel", "void at::native::warmup_kernel()", 2, 1,
               correlation=1),
           _ev("user_annotation", trace.WINDOW_RANGE, 10, 20),
           _ev("cpu_op", "aten::mm", 11, 5),
           _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
           _ev("kernel", "void flash_fwd_wgmma_kernel<64, true>()", 25, 10,
               correlation=2),
           _ev("cpu_op", "aten::add", 40, 1)]
    kept = trace.window_events(evs)
    assert [e["name"] for e in kept] == [
        "aten::mm", "cudaLaunchKernel",
        "void flash_fwd_wgmma_kernel<64, true>()"]
    assert trace.comm_report_in(kept)["device_sec"] == pytest.approx(10e-6)
    assert trace.window_events(evs[:2]) == evs[:2]


def _window_events():
    """A window of two segmented flash forwards and backwards (three
    kernels a backward) and two layernorm backwards (two kernels each),
    as the profiler writes their names."""
    names = (["void (anonymous namespace)::flash_fwd_wgmma_kernel"
              "<128, true>(CUtensorMap)"] * 2
             + ["void (anonymous namespace)::flash_bwd_delta_kernel"
                "<__nv_bfloat16>(float*)",
                "void (anonymous namespace)::flash_bwd_dq_wgmma_kernel"
                "<128, true>(CUtensorMap)",
                "void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel"
                "<128, true>(CUtensorMap)"] * 2
             + ["void (anonymous namespace)::lnb_reg_kernel"
                "<__nv_bfloat16, false, 8, 8>(float*)",
                "void (anonymous namespace)::lnb_colsum_kernel"
                "<float>(float*)"] * 2)
    launches = {"flash_attention_seg_fwd": 2, "flash_attention_seg_bwd": 2,
                "layernorm_bwd": 2}
    return [_ev("kernel", n, 10 * i, 5) for i, n in enumerate(names)], \
        launches


@pytest.mark.parametrize("drop", [None, "flash_fwd_wgmma", "flash_bwd_dq",
                                  "lnb_colsum"])
def test_lost_event_guard_holds_each_kernel_to_its_launches(drop):
    """The guard per kernel: a window whose trace lacks one event of a
    forward, or of one of the kernels a backward launch puts on the card,
    is short although its events still outnumber its launches (the sum
    the guard once compared)."""
    from cxxnet_tpu_torch.monitor import trace
    evs, launches = _window_events()
    if drop is not None:
        (i,) = [i for i, e in enumerate(evs) if drop in e["name"]][:1]
        del evs[i]
    assert len(evs) > sum(launches.values())
    short = trace.kernel_shortfall(evs, launches)
    if drop is None:
        assert short == {}
        return
    ((names, (want, got)),) = short.items()
    assert drop in names and (want, got) == (2, 1)


def test_kernel_registry_names_every_hand_written_kernel():
    """ops.WRAPPERS names each __global__ of ops/csrc in a kernel that a
    launch puts on the card once, except the layernorm backward's
    stream-route row pass, and names nothing else; the registry's
    counters are the wrappers' own."""
    import glob
    import re
    from cxxnet_tpu_torch import ops
    named = {k for _, _, kernels in ops.WRAPPERS for names in kernels
             for k in names}
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^()]*(?:\([^()]*\)[^()]*)*\)\s*)?(?:void\s+)?"
                     r"([A-Za-z_]\w*)\s*\(", re.S)
    defined = set()
    for path in glob.glob(os.path.join(REPO, "cxxnet_tpu_torch", "ops",
                                       "csrc", "*.cu*")):
        defined.update(pat.findall(open(path).read()))
    assert "flash_fwd_wgmma_kernel" in defined
    assert named == defined - {"lnb_rowstats_kernel"}
    counts = ops.launch_counts()
    assert set(counts) == {fn for _, fn, _ in ops.WRAPPERS}
    assert all(n >= 0 for n in counts.values())


def test_backward_kernels_join_their_forward_scope():
    """Synthetic CUDA-shaped events: a forward launch inside a scope
    range, a backward launch on another (the autograd engine's) thread
    under an evaluate_function op whose sequence number is the forward
    op's, and an updater launch outside both."""
    from cxxnet_tpu_torch.monitor import attribution
    evs = [
        _ev("user_annotation", "00-fc1", 0, 10),
        _ev("cpu_op", "aten::mm", 1, 5, **{"Sequence number": 7,
                                           "Fwd thread id": 0}),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
            50, 10, tid=2, **{"Sequence number": 7, "Fwd thread id": 1}),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, tid=2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=3),
        _ev("kernel", "gemm_fwd", 3, 4, tid=7, correlation=1),
        _ev("kernel", "gemm_bwd", 53, 6, tid=7, correlation=2),
        _ev("kernel", "fused_adam_kernel", 81, 2, tid=7, correlation=3)]
    placed = {p["name"]: p for p in
              attribution.attribute_events(evs, ["00-fc1"])}
    assert placed["gemm_fwd"]["scope"] == "00-fc1"
    assert not placed["gemm_fwd"]["backward"]
    assert placed["gemm_bwd"]["scope"] == "00-fc1"
    assert placed["gemm_bwd"]["backward"]
    assert placed["fused_adam_kernel"]["scope"] is None
    table = attribution.layer_table(evs, ["00-fc1"])
    rows = {r["layer"]: r for r in table["rows"]}
    assert rows["00-fc1"]["device_ms"] == pytest.approx(0.01)
    assert rows["00-fc1"]["bwd_ms"] == pytest.approx(0.006)
    assert rows["(unattributed)"]["device_ms"] == pytest.approx(0.002)


# ------------------------------------------------------------- off path

def test_plane_off_enters_no_range_and_no_norm_code(monkeypatch):
    """monitor = 0, no profile window: one update enters no
    per-connection profiler range and calls none of the norm code; with
    monitor = 1 at a tick it does."""
    import cxxnet_tpu_torch.monitor.ingraph as ingraph
    import cxxnet_tpu_torch.nnet.net as netmod
    calls = {"range": 0, "norm": 0}
    real_rf = netmod.record_function

    def counting_rf(name):
        calls["range"] += 1
        return real_rf(name)

    def counting(fn):
        def run(*a, **k):
            calls["norm"] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(netmod, "record_function", counting_rf)
    for name in ("snapshot", "group_stats", "unpack_stats"):
        monkeypatch.setattr(ingraph, name, counting(getattr(ingraph, name)))
    t = _port_trainer(TINY_MLP, 16)
    t.start_round(1)
    t.update(_nan_batch(nan=False))
    assert calls == {"range": 0, "norm": 0}
    assert t._last_monitor is None and not t.net.profile_scopes
    t = _port_trainer(TINY_MLP, 16, [("monitor", "1"),
                                     ("monitor_interval", "1")])
    t.net.profile_scopes = True
    t.start_round(1)
    t.update(_nan_batch(nan=False))
    assert calls["range"] == len(t.net.connections) and calls["norm"] == 3


def test_reload_keeps_layer_sections_apart(tmp_path):
    """A snapshot of a conf with a netconfig block (MNIST_CONV.conf's
    net) reloads, as rollback and continue = 1 reload it, with the shapes
    it was built with: a conv's ``pad = 1`` stays the conv's and does not
    reach the max pool after it."""
    from cxxnet_tpu_torch.utils.config import parse_config_file
    conf = tmp_path / "c.conf"
    text = open(os.path.join(REPO, "example", "MNIST",
                             "MNIST_CONV.conf")).read()
    conf.write_text(text[text.index("netconfig=start"):]
                    + "\nbatch_size = 4\ndev = cpu\nsilent = 1\n")
    task = LearnTask()
    for k, v in parse_config_file(str(conf)):
        task.set_param(k, v)
    fresh = task._create_net()
    fresh.init_model()
    fresh.save_model(str(tmp_path / "0001.model"))
    loaded = task._create_net()
    loaded.load_model(str(tmp_path / "0001.model"))
    assert loaded.net.node_shapes == fresh.net.node_shapes
    assert fresh.net.node_shapes[2][2:] == (7, 7)


# ------------------------------------------------- cost and memory records

def _jax_cost_columns(c, ms, steps, peak_flops, peak_bw):
    """The JAX package's row columns (cxxnet_tpu/monitor/attribution.py
    ``layer_table``) for a row of ``ms`` device time over ``steps``."""
    row = {"flops": c["flops"], "bytes": c["bytes"]}
    sec = ms / steps / 1e3
    if sec > 0 and peak_flops:
        row["mfu_pct"] = round(c["flops"] / sec / peak_flops * 100.0, 2)
    if peak_flops and peak_bw:
        floor_ms = max(c["flops"] / peak_flops, c["bytes"] / peak_bw) * 1e3
        row["roofline_ms"] = round(floor_ms, 4)
        if floor_ms > 0:
            row["roofline_x"] = round(ms / steps / floor_ms, 2)
    return row


@pytest.mark.parametrize("peaks", [True, False], ids=["h100", "cpu"])
def test_layer_table_cost_columns_match_jax(peaks):
    """Scripted events: a connection's row carries the JAX package's
    cost columns against the card's peaks; without peaks (the CPU) only
    flops and bytes, as in the JAX package; the unattributed row none."""
    from cxxnet_tpu_torch.analysis import costmodel
    from cxxnet_tpu_torch.monitor import attribution
    evs = [_ev("user_annotation", "00-fc1", 0, 10),
           _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
           _ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=3),
           _ev("kernel", "gemm_fwd", 3, 40, tid=7, correlation=1),
           _ev("kernel", "fused_adam_kernel", 81, 2, tid=7, correlation=3)]
    costs = {"00-fc1": {"flops": 6.0e9, "bytes": 1.2e7}}
    pf = costmodel.peak_flops(costmodel.H100) if peaks else None
    pb = costmodel.peak_bw(costmodel.H100) if peaks else None
    table = attribution.layer_table(evs, ["00-fc1"], steps=2, costs=costs,
                                    peak_flops=pf, peak_bw=pb)
    rows = {r["layer"]: r for r in table["rows"]}
    want = _jax_cost_columns(costs["00-fc1"], 0.040, 2, pf, pb)
    got = {k: rows["00-fc1"][k] for k in ("flops", "bytes", "mfu_pct",
                                          "roofline_ms", "roofline_x")
           if k in rows["00-fc1"]}
    assert got == want
    assert set(want) == ({"flops", "bytes", "mfu_pct", "roofline_ms",
                          "roofline_x"} if peaks else {"flops", "bytes"})
    assert not {"flops", "mfu_pct"} & set(rows["(unattributed)"])


def _scripted_probe(steps):
    """An AllocProbe over a scripted counter: ``steps`` bytes added at
    each reading in turn, and a peak 500 bytes above the last."""
    from cxxnet_tpu_torch.monitor.memory import AllocProbe
    live = [10_000]
    it = iter(steps)

    def read():
        live[0] += next(it)
        return live[0]

    return AllocProbe(read, peak=lambda: live[0] + 500)


def test_mem_table_keys_match_jax_and_scripted_values():
    """mem_table over a scripted allocator: the JAX package's payload
    keys (its mem_table over its HLO fixture), each connection's rise as
    its act_bytes, the model's columns, peak and timeline over the
    step's start."""
    from cxxnet_tpu.monitor import memory as jmemory
    from cxxnet_tpu_torch.monitor import memory
    probe = _scripted_probe([0, 400, 0, 1200, -100, 3000, -2000])
    probe.start()
    for scope in ("00-fc1", "01-relu", "02-fc2", "03-softmax"):
        probe.mark(scope)
    probe.mark(memory.BACKWARD)
    probe.mark(memory.UPDATE)
    probe.finish()
    table = memory.mem_table(
        probe, param_rows={"00-fc1": {"param_bytes": 800,
                                      "opt_bytes": 1600}},
        model_rows={"00-fc1": {"param_bytes": 800, "opt_bytes": 1600,
                               "act_bytes": 400},
                    "02-fc2": {"act_bytes": 1000}})
    text = open(os.path.join(REPO, "tests", "fixtures",
                             "step_mlp.hlo")).read()
    jtable = jmemory.mem_table(
        text, ["00-fc1", "01-act", "02-loss"],
        exec_stats={"temp_bytes": 1, "args_bytes": 1},
        param_rows={"00-fc1": {"param_bytes": 1, "opt_bytes": 1}},
        model_rows={"00-fc1": {"param_bytes": 1}})
    assert set(table) == set(jtable)
    assert {k for r in table["rows"] for k in r} \
        == {k for r in jtable["rows"] for k in r}
    rows = {r["layer"]: r for r in table["rows"]}
    assert {s: r["act_bytes"] for s, r in rows.items()} == {
        "00-fc1": 400, "01-relu": 0, "02-fc2": 1200, "03-softmax": 0}
    assert rows["00-fc1"]["total_bytes"] == 2800
    assert rows["00-fc1"]["model_bytes"] == 2800
    assert rows["00-fc1"]["model_x"] == 1.0
    assert rows["02-fc2"]["model_x"] == 1.2
    assert table["rows"][0]["layer"] == "00-fc1"
    assert table["timeline"] == [0, 400, 400, 1600, 1500, 4500, 2500]
    # the peak: the allocator's (12_500 + 500) or the highest reading
    # (14_500, after the backward), whichever is higher, over the start's
    assert table["peak_live_bytes"] == 4500
    assert table["peak_frac"] == round(5 / 6, 4)
    assert table["coverage"] == round(1600 / 4500, 4)
    assert table["exec"] == {"args_bytes": 10_000, "out_bytes": 2500,
                             "temp_bytes": 4500}
    # a connection that frees bytes: the rises add up without the fall
    # between them, so coverage passes 1 (the JAX ratio, uncapped)
    probe = _scripted_probe([0, 3000, -2500, 3000, -2000, 0, -1000])
    probe.start()
    for scope in ("00-fc1", "01-relu", "02-fc2", "03-softmax"):
        probe.mark(scope)
    probe.mark(memory.BACKWARD)
    probe.mark(memory.UPDATE)
    probe.finish()
    table = memory.mem_table(probe)
    assert table["peak_live_bytes"] == 3500
    assert table["coverage"] == round(6000 / 3500, 4) > 1


@pytest.mark.parametrize("remat", ["0", "2"])
def test_mem_probe_reads_each_connection_once(remat):
    """A probe reads the allocator once after each connection's forward,
    under ``remat`` too, where the segments run their connections
    themselves and run them again in the backward (the recompute is not
    read): every connection gets a nonzero act_bytes."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.monitor import memory
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    tr = NetTrainer()
    for k, v in parse_config_string(MLP_NET) + [
            ("input_shape", "1,1,16"), ("batch_size", "4"), ("dev", "cpu"),
            ("remat", remat)]:
        tr.set_param(k, v)
    tr.init_model()
    rnd = np.random.RandomState(0)
    batch = DataBatch(data=rnd.rand(4, 1, 1, 16).astype(np.float32),
                      label=rnd.randint(0, 4, (4, 1)).astype(np.float32),
                      index=np.arange(4))
    probe = memory.AllocProbe(lambda: 1000 * len(probe.marks))
    tr.mem_probe = probe
    tr.update(batch)
    scopes = tr.layer_scopes()
    assert [m for m, _ in probe.marks] == (
        [memory.START] + scopes + [memory.BACKWARD, memory.UPDATE])
    rows = {r["layer"]: r for r in memory.mem_table(probe)["rows"]}
    assert {s: rows[s]["act_bytes"] for s in scopes} \
        == {s: 1000 for s in scopes}


def test_mem_profile_record_through_the_cli_reads_in_obsv_and_diff(
        golden, tmp_path, monkeypatch):
    """A CPU train run with a profile window whose first dispatch reads a
    scripted allocator (the card's probe patched in): one ``mem_profile``
    record with the model's totals, which tools/obsv.py renders and the
    port's monitor/diff.py reads, unedited."""
    from cxxnet_tpu_torch.monitor import diff, memory

    def arm(self, prof):
        if prof.active and self._mem_probe is None:
            self._mem_probe = self.net.mem_probe = memory.AllocProbe(
                lambda: 1000 * len(self._mem_probe.marks),
                peak=lambda: 50_000)

    monkeypatch.setattr(LearnTask, "_arm_mem_probe", arm)
    sink = tmp_path / "m.jsonl"
    assert LearnTask().run([_golden_conf(golden, "mem"), "num_round=1",
                            f"metrics_sink=jsonl:{sink}",
                            f"prof={tmp_path}/prof", "prof_start_step=1",
                            "prof_num_steps=2"]) == 0
    recs = _records(sink)
    (mp,) = [r for r in recs if r["kind"] == "mem_profile"]
    assert [r["layer"] for r in mp["rows"]][:2] == ["00-fc1", "02-fc2"]
    assert {r["layer"] for r in mp["rows"]} == {
        "00-fc1", "01-relu", "02-fc2", "03-softmax"}
    assert all(r["act_bytes"] == 1000 for r in mp["rows"])
    assert mp["peak_live_bytes"] == 50_000 and mp["coverage"] > 0
    assert mp["model"]["est_peak_bytes"] > mp["model"]["param_bytes"] > 0
    assert "hbm_capacity_bytes" not in mp      # no card, no capacity
    assert diff.run_metrics(recs)["peak_live_bytes"][0] == 50_000
    obsv = os.path.join(REPO, "tools", "obsv.py")
    r = subprocess.run([sys.executable, obsv, str(sink)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "memory (round 0): peak live" in r.stdout
    assert "x_model" in r.stdout

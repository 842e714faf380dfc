"""Trainer core: configuration, model init, snapshot load / save, the
eval forward and the training step (the JAX package's ``NetTrainer``).

A training step (:meth:`NetTrainer.update`) runs the forward under
autograd with the batch's label fields, takes ``torch.autograd.grad`` of
the summed loss terms (each already scaled by 1 / (batch_size *
update_period)) and hands each (layer, tag) gradient to the updater.
The three parts run inside ``train_forward`` / ``train_backward`` /
``train_update`` profiler ranges, which ``chip_smoke.py --profile``
reads.
With ``update_period = K > 1`` the gradients of K batches are summed
before one update, as in the JAX package.  Optimizer state is made at
the first update (a serving trainer never holds it).

Lowering keys of the JAX package's trainer, each the same function
computed another way: ``remat = K`` checkpoints K segments of the body
(:meth:`NetTrainer._remat_forward`; dropout and insanity masks drawn
again in the recompute from the generator state of the forward),
``batch_split = K`` runs the batch as K sub-batch chains whose losses
add (their masks drawn one chain after the other), ``input_s2d = 1``
feeds the first conv its input in space-to-depth form
(:meth:`NetTrainer.stage_input`) and ``conv_sibling_fuse = 1`` runs convs
of one input and one geometry as one conv
(:meth:`NetTrainer._fuse_sibling_convs`).  Running buffers
(batch_norm's moving statistics) are updated by every training forward.

``metric[label,node] = name`` keys bind evaluation metrics to nodes (the
final node by default): :meth:`NetTrainer.evaluate` runs them over an
eval iterator, and with ``eval_train = 1`` (the default) every training
step adds its eval-node outputs to the train metric.  At build time the
relu -> max pool reorder moves a relu that feeds only a max pool after
it, and with it the bias of the conv beneath
(:meth:`NetTrainer._reorder_relu_pool`); a node read at call time
(:meth:`NetTrainer.extract_feature`) gets the relu and the bias back.
:meth:`NetTrainer.predict` / :meth:`~NetTrainer.predict_raw` serve
``task = pred`` / ``pred_raw``, and :meth:`NetTrainer.copy_model_from`
``task = finetune``.

Snapshots: :meth:`NetTrainer.save_model` writes the legacy ``.model``
and :meth:`NetTrainer.checkpoint_payload` the shards and manifest of an
atomic ``NNNN.ckpt`` directory (:mod:`..ckpt`); :meth:`NetTrainer.load_model`
reads either.  Both carry :meth:`NetTrainer.train_state` (counters and
the rng), so a resumed run continues the trajectory it was cut from;
:meth:`NetTrainer.reseed_rng` moves the rng past a diverged window for a
rollback.

Telemetry (doc/monitor.md): a ``run`` record at model build; ``monitor
= 1`` takes per-leaf weight / grad / update norms and checks the loss
every ``monitor_interval`` steps (:meth:`NetTrainer._monitor_tick`;
nothing of it runs on other steps or at ``monitor = 0``);
``trace_sample`` arms the metrics' span tracer; the
``train_step_traces`` / ``eval_step_traces`` counters count the batch
shapes each step saw; :meth:`NetTrainer.memory_gauges` reads the
caching allocator, :meth:`NetTrainer.arm_mem_probe` reads it through one
step, connection by connection, and :meth:`NetTrainer.layer_scopes`
names the connection ranges a profile window joins kernels against.
:meth:`NetTrainer.init_model` builds the net on ``meta`` tensors for
``task = check``; ``strict_config = 1`` has the layers report the keys
they drop.

Data parallelism (``parallel/``, the JAX package's mesh): with a ``dev``
of several ids, a ``mesh`` or in a process group of several ranks, each
rank holds a :class:`~..parallel.mesh.Mesh` and trains on its rows of
every batch (:meth:`NetTrainer.stage_batch`,
:meth:`NetTrainer._local_rows`); :meth:`NetTrainer.update_step` sums
the gradients over ``data`` after the backward, or bucket by bucket from
it under ``dp_overlap = 1`` (:meth:`NetTrainer._dp_mode`); ZeRO and the
model axis's shards follow ``parallel/data.py`` and snapshots hold the
logical arrays.  :meth:`NetTrainer.check_weight_consistency` is
``test_on_server``'s replica check.  A ``seq`` axis that divides the
input's positions splits them too (``seq_split``: a rank stages its
block of every row and of each per-position label field, the step's
gradients and loss sum over ``data`` and ``seq``); a moe layer's
per-expert leaves are held as their block of experts on the axis
hosting them (``expert_sharded``), and the gradients of what the
``model`` / ``expert`` ranks compute alike are made bitwise one before
the update.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import ckpt, engine
from ..analysis.schema import K
from ..layers.base import ForwardContext, LabelInfo, materialize
from ..monitor import TrainingDiverged, ingraph, log as mlog
from ..monitor.memory import BACKWARD, UPDATE, AllocProbe
from ..monitor.metrics import Metrics, device_memory_gauges
from ..parallel import data as dplib, mesh as meshlib
from ..parallel.mesh import MeshSpec, parse_device_spec
from ..updater.updaters import UpdaterHyper, create_updater
from ..utils import serializer
from ..utils.metric import MetricSet
from .net import Network, Params
from .netconfig import NetConfig, global_pairs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

def _metric_check(val: str):
    """Lint-time metric-name validation through the real factory."""
    from ..utils.metric import create_metric
    try:
        create_metric(val)
        return None
    except ValueError as e:
        return str(e)


def _mesh_check(val: str):
    try:
        MeshSpec.parse(val)
        return None
    except ValueError as e:
        return f"invalid mesh spec: {e}"


#: keys NetTrainer.set_param consumes (the engine options declare
#: themselves in engine.py; ``metric[...]`` spellings match as a
#: template).  The declared-key registry (analysis/registry.py) reads
#: them; keep them in step with set_param below.
TRAINER_KEYS = (
    K("batch_size", "int", lo=1), K("update_period", "int", lo=1),
    K("seed", "int"), K("dev", "str"),
    K("dtype", "enum", choices=("float32", "bfloat16", "float16")),
    K("mesh", "str", check=_mesh_check, help="axis:size[,axis:size...]"),
    K("fullc_gather", "int", lo=0, hi=1),
    K("pipe_microbatch", "int", lo=0),
    K("pipe_schedule", "enum", choices=("gpipe", "1f1b")),
    K("batch_split", "int", lo=1), K("remat", "int", lo=0),
    K("scale", "float"), K("mean_value", "str"),
    K("shard_opt_state", "int", lo=0, hi=1),
    K("update_on_server", "int", lo=0, hi=1),
    K("silent", "int", lo=0, hi=1),
    K("monitor", "int", lo=0, hi=1),
    K("monitor_interval", "int", lo=1),
    K("monitor_nan", "enum", choices=("warn", "fatal", "off")),
    K("metrics_sink", "str", help="jsonl:<path> or none"),
    K("trace_sample", "int", lo=0, hi=1000000,
      help="host-side span tracing: trace every Nth request/item "
           "through the request path (span records; 0 = off; needs "
           "metrics_sink)"),
    K("eval_train", "int", lo=0, hi=1), K("eval_group", "int", lo=1),
    K("input_s2d", "int", lo=0, hi=1), K("print_step", "int", lo=1),
    K("metric", "str", check=_metric_check,
      help="error/rmse/logloss/rec@n, repeatable"),
    K("metric[*]", "str", check=_metric_check,
      help="scoped metric[field] / metric[field,node]"),
    K("strict_config", "int", lo=0, hi=1,
      help="route silently-ignored config keys through the lint "
           "reporter as warnings"),
)

def resolve_device(dev: str, rank: int = 0) -> torch.device:
    """``dev`` -> this rank's torch device.  ``cpu`` (any ids) runs on
    the CPU; ``gpu``, ``cuda`` and the JAX package's accelerator names
    (``tpu``, with optional ids) run on the card, and raise when there
    is none — an accelerator request never lands on the CPU.  Several
    ids (``:i-j``, ``:i,j``) are a data mesh of one rank a device: rank
    ``rank`` takes the ``rank``-th id, and a range naming more cards
    than are visible is refused with both counts."""
    spec = parse_device_spec(dev.lower())
    platform = spec["platform"]
    if platform not in ("cpu", "gpu", "cuda", "tpu"):
        raise ValueError(f"dev = {dev!r}: expected cpu, gpu[:i], cuda[:i] "
                         "or tpu[:i]")
    listed = spec["ids"] or []
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dev = {dev}: no CUDA device is available; set dev = cpu to "
            "run on the CPU")
    if len(listed) > 1:
        return meshlib.select_devices(dev)[rank]
    return torch.device("cuda", listed[0] if listed else 0)


def _torch_leaf(a, dtype_name: Optional[str]) -> torch.Tensor:
    arr = np.asarray(a)
    name = dtype_name or arr.dtype.name
    if name not in DTYPES:
        raise ValueError(f"params_from_jax: unsupported dtype {name!r}")
    return torch.from_numpy(np.array(arr, np.float32)).to(DTYPES[name])


def flat_tags(group: Dict, depth: int = 0) -> Dict:
    """A layer group with nested sub-groups (a pairtest layer's
    ``{"master": {...}, "slave": {...}}``, as the JAX package keeps it)
    as the port's flat ``{"master/wmat": leaf}`` tags.  ``depth`` is how
    many dict levels a leaf keeps (1 for optimizer state, whose leaf is
    ``{name: array}``)."""
    out: Dict = {}

    def walk(d: Dict, prefix: str) -> None:
        for k, v in d.items():
            if isinstance(v, dict) and _nesting(v) > depth:
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = v

    walk(group, "")
    return out


def _nesting(v) -> int:
    """Dict levels above the leaves of ``v``."""
    if not isinstance(v, dict) or not v:
        return 0
    return 1 + max(_nesting(x) for x in v.values())


def _torch_group(tree: Dict, group: str, dtypes: Dict[str, str]) -> Params:
    """``{param_key: {tag: array}}`` of snapshot group ``group`` -> CPU
    tensors in the dtypes ``dtypes`` records for its flattened keys
    (nested sub-groups become ``a/b`` tags, :func:`flat_tags`)."""
    return {pkey: {tag: _torch_leaf(a, dtypes.get(f"{group}/{pkey}/{tag}"))
                   for tag, a in flat_tags(g).items()}
            for pkey, g in tree.items()}


def params_from_jax(params_np: Dict, buffers_np: Dict,
                    dtypes: Optional[Dict[str, str]] = None
                    ) -> Tuple[Params, Params]:
    """The JAX package's nested ``{param_key: {tag: array}}`` params and
    buffers (numpy, bfloat16 allowed) -> the port's CPU tensors, same
    keys (``wmat``, ``bias``, ``wqkv``, ``bqkv``, ``wout``, ``bout``,
    ``wpos``).  ``dtypes`` is a ``.model`` header's map from flattened
    key (``params/<key>/<tag>``) to the dtype a float32-stored leaf had."""
    dtypes = dtypes or {}
    return (_torch_group(params_np, "params", dtypes),
            _torch_group(buffers_np, "buffers", dtypes))


def opt_state_from_jax(opt_np: Dict) -> Dict:
    """The JAX package's optimizer state ``{param_key: {tag: {name:
    array}}}`` (``m`` for sgd / nag, ``m1`` / ``m2`` for adam, ``w32``
    masters; all float32) -> the port's CPU float32 tensors."""
    return {pkey: {tag: {k: torch.from_numpy(np.array(a, np.float32))
                         for k, a in st.items()}
                   for tag, st in flat_tags(g, depth=1).items()}
            for pkey, g in opt_np.items()}


def read_snapshot(path: str, validated: bool = False
                  ) -> Tuple[dict, Dict, Dict, Optional[Dict], Optional[Dict]]:
    """``(header, params, buffers, opt or None, acc or None)`` of a
    ``.model`` file or a ``NNNN.ckpt`` directory written by either
    package, as nested dicts of numpy arrays (bfloat16 stored as float32
    and named in ``header["dtypes"]``).  ``validated``: the caller has
    just checked the directory's checksums, so they are not read again."""
    if not os.path.isdir(path):
        header, params, buffers, opt = serializer.load_model(path)
        return header, params, buffers, opt, None
    manifest, shards = ckpt.load_snapshot(path, assume_valid=validated)
    tree: Dict = {}
    for arrays in shards.values():
        tree.update(serializer.unflatten_tree(arrays))
    header = {"net": manifest["net"], "epoch": manifest["epoch"],
              "has_opt_state": manifest.get("has_opt_state"),
              "dtypes": manifest.get("dtypes") or {},
              "extra": manifest.get("extra") or {}}
    opt = tree.get("opt") if header["has_opt_state"] else None
    return (header, tree.get("params", {}), tree.get("buffers", {}), opt,
            tree.get("acc"))


def jax_rng_key(seed: int) -> List[int]:
    """The key the JAX package's ``jax.random.PRNGKey(seed)`` makes (two
    uint32 words: the seed's high and low 32 bits), which its snapshots
    carry as ``rng_key``.  The port draws from a ``torch.Generator``
    instead and carries its state beside it."""
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


def _host_tree(tree: Dict) -> Dict:
    """Nested tensors -> independent CPU copies: the updaters rewrite
    parameters and state in place, so a view of a CPU tensor handed to
    the async writer would change while it is serialized."""
    return {k: _host_tree(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in tree.items()}


def diagnostics_to_host(steps: Sequence[Dict[str, torch.Tensor]]
                        ) -> List[Dict[str, float]]:
    """Each step's diagnostics (:attr:`NetTrainer.last_diags`, 0-d device
    tensors) as host floats, all of them read in one transfer."""
    keys = [sorted(d) for d in steps]
    flat = [d[k].detach().float().reshape(())
            for d, ks in zip(steps, keys) for k in ks]
    if not flat:
        return [{} for _ in steps]
    vals = iter(torch.stack([v.to(flat[0].device) for v in flat])
                .cpu().tolist())
    return [{k: next(vals) for k in ks} for ks in keys]


class NetTrainer:
    """Config-driven trainer: ``set_param`` / ``init_model`` /
    ``load_model`` / ``save_model`` / ``update`` / ``forward_eval``."""

    def __init__(self) -> None:
        self.cfg: List[Tuple[str, str]] = []
        self.batch_size = 0
        self.update_period = 1
        self.seed = 0
        self.dev = "gpu"
        self.dtype = torch.float32
        self.silent = 0
        self.round = 0
        self.epoch_counter = 0
        self.sample_counter = 0
        self.opts = engine.EngineOptions()
        self.metrics = Metrics()
        self.net: Optional[Network] = None
        self.netcfg: Optional[NetConfig] = None
        self.device: Optional[torch.device] = None
        self.params: Params = {}
        self.buffers: Params = {}
        self.hypers: Dict[str, Dict[str, UpdaterHyper]] = {}
        self.opt_state: Optional[Dict] = None
        self._opt_host: Optional[Dict] = None  # loaded, installed lazily
        self._grad_acc: Optional[Dict] = None
        self.last_loss: Optional[torch.Tensor] = None
        # (metric name, label field, node name or "" for the final node)
        self._metric_req: List[Tuple[str, str, str]] = []
        self.eval_train = 1
        self.eval_node_ids: List[int] = []
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        self.rng: Optional[torch.Generator] = None
        # node id -> ("relu" | "bias", conv param key or None): what the
        # relu -> pool reorder took out of the node's stored value
        self._read_fixups: Dict[int, Tuple[str, Optional[str]]] = {}
        # the layer names the last copy_model_from copied
        self.copied_layers: List[str] = []
        # the loaded snapshot's extra (iterator state for the task driver)
        self.loaded_extra: Optional[Dict] = None
        # remat = K: K checkpointed segments of the body (0: none); the
        # partition is made at the first step
        self.remat = 0
        self._remat_partition = None
        # batch_split = K: K sub-batch chains a step
        self.batch_split = 1
        # input_s2d = 1: the first conv takes its input in space-to-depth
        # form; its geometry (stride, kh, kw, oh, ow, pad_y, pad_x)
        self.input_s2d = 0
        self._s2d_args: Optional[Tuple[int, ...]] = None
        # u8 batches (output_u8 = 1 iterators) are normalised on the
        # device: (x - mean_value[c]) * scale, the host iterators' rule;
        # the mean held on the device once
        self.input_scale = 1.0
        self.input_mean: Optional[np.ndarray] = None
        self._mean_dev: Dict[Tuple[str, int], torch.Tensor] = {}
        # monitor = 1: per-leaf weight / grad / update norms and the
        # NaN / inf loss guard every monitor_interval steps; monitor_nan
        # is the guard's action (warn, fatal or off)
        self.monitor = 0
        self.monitor_interval = 100
        self.monitor_nan = "warn"
        self._last_monitor: Optional[Dict[str, torch.Tensor]] = None
        # monitored steps taken (the train loop keeps the windows holding
        # an extra tick out of the throughput sentinel)
        self.monitor_ticks = 0
        # distinct batch shapes the train step and the eval forward saw
        # (the JAX package's retrace counters: a new shape retraces its
        # jitted step)
        self._train_shapes: set = set()
        self._eval_shapes: set = set()
        # a monitor/memory.AllocProbe the next update step reads the
        # allocator into (arm_mem_probe), and the allocator's high-water
        # before the probe last reset it (memory_gauges keeps it)
        self.mem_probe = None
        self._hbm_floor = 0
        # the last training step's diagnostics (pairtest layers' relative
        # errors: 0-d tensors on the device, the JAX package's
        # _last_diags)
        self.last_diags: Dict[str, torch.Tensor] = {}
        # the data-parallel plane (parallel/): ``mesh`` (None on one
        # device; a caller may install one before the build, e.g. two
        # gloo ranks on one card), the configured spec, ZeRO and the
        # model-axis fullc shards (parallel/data.py), the dp_overlap
        # bucket plan and its one-shot fallback warnings
        self.mesh: Optional[meshlib.Mesh] = None
        self.mesh_spec: Optional[MeshSpec] = None
        self.shard_opt_state = 0
        self.fullc_gather = 0
        self.model_sharded: Dict[Tuple[str, str], Tuple[int, ...]] = {}
        self.zero_leaves: set = set()
        # moe per-expert leaves held as their block of experts: (pkey,
        # tag) -> (the axis hosting the experts, logical rows)
        self.expert_sharded: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # a seq axis wider than 1 dividing the input's positions: each
        # rank holds its block of every row's positions
        self.seq_split = False
        self._dp_plan_state = None
        self._dp_warned: set = set()
        # mesh = ...,pipe:K (parallel/pipeline.py): microbatches a step
        # (0: twice the stages), the schedule, and what the first
        # pipelined step works out: the partition, the bucket plan of
        # dp_overlap = 1 under 1f1b, the boundaries' wire specs (by
        # microbatch shape), and the last step's schedule statistics
        self.pipe_microbatch = 0
        self.pipe_schedule = "gpipe"
        self._pipe_partition = None
        self._pipe_bucket_state = None
        self._pipe_specs: Dict = {}
        self.pipe_stats: Dict[str, int] = {}

    def set_param(self, name: str, val: str) -> None:
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "update_period":
            self.update_period = int(val)
            if self.update_period < 1:
                raise ValueError(f"update_period = {val}: expected >= 1")
        elif name == "seed":
            self.seed = int(val)
        elif name == "dev":
            self.dev = val
        elif name == "dtype":
            if val not in DTYPES:
                raise ValueError(f"dtype = {val}: expected one of "
                                 f"{sorted(DTYPES)}")
            self.dtype = DTYPES[val]
        elif name == "mesh":
            self.mesh_spec = MeshSpec.parse(val)
        elif name == "pipe_microbatch":
            self.pipe_microbatch = int(val)
        elif name == "pipe_schedule":
            if val not in ("gpipe", "1f1b"):
                raise ValueError(f"pipe_schedule = {val}: expected gpipe "
                                 "or 1f1b")
            self.pipe_schedule = val
        elif name in ("shard_opt_state", "update_on_server"):
            # update_on_server = 1 (server-side optimizer state) is ZeRO
            # over the data axis, as in the JAX package
            self.shard_opt_state = int(val)
        elif name == "fullc_gather":
            self.fullc_gather = int(val)
        elif name == "remat":
            self.remat = int(val)
        elif name == "batch_split":
            self.batch_split = int(val)
            if self.batch_split < 1:
                raise ValueError(f"batch_split = {val}: expected >= 1")
        elif name == "input_s2d":
            self.input_s2d = int(val)
        elif name == "scale":
            # device-side normalisation of u8 batches: the same global
            # keys the host iterators consume
            self.input_scale = float(val)
        elif name == "mean_value":
            self.input_mean = np.array(
                [float(v) for v in val.split(",") if v.strip()], np.float32)
            self._mean_dev = {}
        elif name == "monitor":
            self.monitor = int(val)
        elif name == "monitor_interval":
            self.monitor_interval = int(val)
        elif name == "monitor_nan":
            if val not in ("warn", "fatal", "off"):
                raise ValueError(f"monitor_nan = {val}: expected warn, fatal "
                                 "or off")
            self.monitor_nan = val
        elif name == "trace_sample":
            self.metrics.configure_tracer(int(val))
        elif name == "metric" or name.startswith("metric["):
            # metric[label,node] = m | metric[label] = m | metric = m
            m = re.match(r"^metric\[([^,\]]+)(?:,([^\]]+))?\]$", name)
            if name != "metric" and m is None:
                raise ValueError(f"malformed metric key {name!r}")
            self._metric_req.append(
                (val, m.group(1), m.group(2) or "") if m
                else (val, "label", ""))
        elif name == "eval_train":
            self.eval_train = int(val)
        elif engine.is_engine_option(name):
            self.opts.set(name, val)
        elif name == "silent":
            self.silent = int(val)
            mlog.set_silent(self.silent)
        elif name == "metrics_sink":
            self.metrics.configure_sink(val)
        elif name == "strict_config":
            # default off: layers report, rather than drop, keys no
            # subsystem declares
            from ..layers import base as layer_base
            layer_base.set_strict_config(bool(int(val)))
        self.cfg.append((name, val))

    # ---------------------------------------------------------------- init
    def _build_net(self, netcfg: NetConfig,
                   device: Optional[torch.device] = None) -> None:
        assert self.batch_size > 0, "batch_size must be set"
        self.netcfg = netcfg
        self._setup_mesh(device)
        self.model_sharded, self.zero_leaves = {}, set()
        self.expert_sharded = {}
        self.net = Network(netcfg, self.batch_size, self.dtype)
        self.seq_split = self._seq_splits()

    def _setup_mesh(self, device: Optional[torch.device]) -> None:
        """This rank's device and mesh (the JAX package's
        ``_setup_mesh``).  ``mesh`` names the axes; without it a ``dev``
        of several ids is one ``data`` axis over them, and a process of
        a joined group of several (``CXN_*``) one over the group.  A mesh
        the caller installed is kept; on ``meta`` (``task = check``) the
        mesh is virtual: the axes of one rank, no group.  One device
        makes no mesh: no process group, no collective."""
        import torch.distributed as dist
        spec = self.mesh_spec
        ids = parse_device_spec(self.dev.lower())["ids"] or []
        if spec is None and len(ids) > 1:
            spec = MeshSpec({"data": len(ids)})
        joined = dist.is_available() and dist.is_initialized()
        if spec is None and joined and dist.get_world_size() > 1:
            spec = MeshSpec({"data": dist.get_world_size()})
        if self.mesh is not None:
            if spec is not None and spec.axes != self.mesh.axes:
                raise ValueError(f"mesh {spec.axes} does not match the "
                                 f"installed mesh {self.mesh.axes}")
            self.device = device if device is not None else self.mesh.device
        elif device is not None and device.type == "meta":
            self.device = device
            if spec is not None and spec.size > 1:
                self.mesh = meshlib.virtual_mesh(spec, device)
        else:
            rank = dist.get_rank() if joined else 0
            self.device = device if device is not None \
                else resolve_device(self.dev, rank)
            if spec is not None and spec.size > 1:
                if not joined:
                    n = spec.size
                    raise ValueError(
                        f"mesh {spec.axes} needs {n} ranks and this "
                        "process is in no process group: select the "
                        f"devices (dev = cpu:0-{n - 1} or gpu:0-{n - 1}; "
                        "the CLI starts a rank for each) or start the "
                        "ranks with parallel.mesh.spawn")
                self.mesh = meshlib.build_mesh(spec, self.device)
        nd = dplib.data_size(self.mesh)
        if self.batch_size % nd:
            raise ValueError(f"batch_size = {self.batch_size} does not "
                             f"divide over the data axis of {nd}")

    def _seq_splits(self) -> bool:
        """True when this rank holds a block of the positions: a mesh
        with a group whose ``seq`` axis is wider than 1 and divides the
        input's sequence (a (b, 1, 1, s) input)."""
        mesh = self.mesh
        if mesh is None or mesh.virtual or mesh.axis_size("seq") <= 1:
            return False
        shape = self.net.node_shapes[0]
        return (shape[1] == shape[2] == 1
                and shape[3] % mesh.axis_size("seq") == 0)

    def _token_axes(self) -> Tuple[str, ...]:
        return dplib.token_axes(self.seq_split)

    def _data_split(self) -> bool:
        """True when each rank takes its rows of a batch (a real mesh
        with a data axis wider than 1)."""
        return (self.mesh is not None and not self.mesh.virtual
                and dplib.data_size(self.mesh) > 1)

    def _place_state(self) -> None:
        """Cut the logical parameters to what this rank holds: the
        model-axis shards and the moe layers' blocks of experts; note
        the ZeRO leaves."""
        from ..layers.moe import MoELayer
        moe_keys = {c.param_key for c in self.net.connections
                    if isinstance(c.layer, MoELayer)}
        self.model_sharded, self.zero_leaves, self.expert_sharded = \
            dplib.plan_shards(
                self.params, self.mesh,
                fullc_gather=bool(self.fullc_gather),
                shard_opt_state=bool(self.shard_opt_state),
                expert_keys=moe_keys)
        self._slice_params()

    def _shard_of(self, pkey: str, tag: str
                  ) -> Tuple[Optional[str], int]:
        """(the axis leaf ``(pkey, tag)`` is held sharded over on its
        leading dim, its logical rows), or (None, 0) for a whole leaf
        (ZeRO leaves are whole; only their optimizer state is cut)."""
        if (pkey, tag) in self.model_sharded:
            return "model", self.model_sharded[(pkey, tag)][0]
        if (pkey, tag) in self.expert_sharded:
            return self.expert_sharded[(pkey, tag)]
        return None, 0

    def _sharded_leaves(self):
        return list(self.model_sharded) + list(self.expert_sharded)

    def _slice_params(self) -> None:
        for pkey, tag in self._sharded_leaves():
            axis, rows = self._shard_of(pkey, tag)
            self.params[pkey][tag] = dplib.rank_slice(
                self.params[pkey][tag], self.mesh, axis, rows)

    def _opt_view(self, pkey: str, tag: str, p: torch.Tensor):
        """The part of parameter ``p`` whose optimizer state this rank
        holds: its row block for a ZeRO leaf, else all of it."""
        if (pkey, tag) in self.zero_leaves:
            return dplib.axis_block(p, self.mesh, "data")
        return p

    def _run_params(self, params=None):
        """The params a forward reads (``params``, this rank's leaves,
        the trainer's own by default): model-sharded leaves all-gathered
        where a connection first reads them (:class:`~..parallel.data.
        GatheringParams`), else the params themselves."""
        params = self.params if params is None else params
        if not self.model_sharded:
            return params
        return dplib.GatheringParams(params, self.model_sharded, self.mesh)

    def _logical(self, pkey: str, tag: str, a: torch.Tensor
                 ) -> torch.Tensor:
        """A leaf (or its optimizer state) as the logical array: a shard
        gathered over its axis."""
        axis, _ = self._shard_of(pkey, tag)
        return a if axis is None else dplib.gather_leaf(a, self.mesh, axis)

    def _logical_params(self) -> Params:
        """The params as logical arrays (model and expert shards
        gathered)."""
        if not self._sharded_leaves():
            return self.params
        return {pkey: {tag: self._logical(pkey, tag, p)
                       for tag, p in g.items()}
                for pkey, g in self.params.items()}

    def _logical_opt(self) -> Dict:
        """The optimizer state as logical arrays (ZeRO slices gathered
        over ``data``, model shards over ``model``)."""
        def full(pkey, tag, a):
            if (pkey, tag) in self.zero_leaves:
                return dplib.gather_leaf(a, self.mesh, "data")
            return self._logical(pkey, tag, a)
        return {pkey: {tag: {n: full(pkey, tag, a) for n, a in st.items()}
                       for tag, st in g.items()}
                for pkey, g in self.opt_state.items()}

    def _rank_opt(self, pkey: str, tag: str, a: torch.Tensor
                  ) -> torch.Tensor:
        """A logical optimizer-state array cut to this rank's part."""
        if (pkey, tag) in self.zero_leaves:
            return dplib.rank_slice(a, self.mesh, "data",
                                    self.params[pkey][tag].shape[0])
        axis, rows = self._shard_of(pkey, tag)
        return dplib.rank_slice(a, self.mesh, axis, rows)

    def init_model(self, device: Optional[torch.device] = None) -> None:
        """Fresh weights from ``seed``, drawn on the trainer's device.
        ``device = torch.device("meta")`` builds the net with its
        parameters and buffers as meta tensors: shapes and dtypes, no
        storage and no device work, at any width (what ``task = check``
        models, ``analysis/memmodel.py``; such a trainer does not run)."""
        mlog.set_silent(self.silent)
        netcfg = NetConfig()
        netcfg.configure(self.cfg)
        self._build_net(netcfg, device)
        self.params = self.net.init_params(self.seed * 100 + 11, self.device)
        self.buffers = self.net.init_buffers(self.device)
        self._post_build()
        mlog.info(self.net.describe())

    def _post_build(self) -> None:
        """The updater, one hyper group per (layer, tag) — global keys,
        then the layer's own section (reference
        NeuralNet::InitUpdaters) — the loss scale and the counters; on a
        mesh the state is cut to this rank's part first."""
        self._place_state()
        self.updater = create_updater(self.netcfg.updater_type)
        key_to_layer = {c.param_key: i for i, c in
                        enumerate(self.net.connections) if c.owns_params}
        self.hypers = {}
        for pkey, group in self.params.items():
            li = key_to_layer.get(pkey)
            self.hypers[pkey] = {}
            for tag in group:
                # a pairtest side's "master/wmat" takes wmat's overrides
                h = UpdaterHyper(tag=tag.rsplit("/", 1)[-1])
                for k, v in global_pairs(self.netcfg.defcfg):
                    h.set_param(k, v)
                if li is not None:
                    for k, v in self.netcfg.layercfg[li]:
                        h.set_param(k, v)
                self.hypers[pkey][tag] = h
        self.loss_scale = 1.0 / (self.batch_size * self.update_period)
        self._label_fields = self.netcfg.label_fields()
        self.opt_state = None
        self._opt_host = None
        self._grad_acc = None
        self.sample_counter = 0
        self.epoch_counter = 0
        self.eval_node_ids = [self.net.node_id(node) if node
                              else self.net.final_node
                              for _, _, node in self._metric_req]
        self.metric, self.train_metric = MetricSet(), MetricSet()
        for name, field, _ in self._metric_req:
            self.metric.add_metric(name, field)
            self.train_metric.add_metric(name, field)
        self.rng = torch.Generator(
            device="cpu" if self.device.type == "meta" else self.device)
        self.rng.manual_seed(self.seed)
        self._remat_partition = None
        self._pipe_partition = self._pipe_bucket_state = None
        self._pipe_specs = {}
        if self.batch_split > 1 and self.buffers:
            raise ValueError("batch_split needs stateless layers (batch_norm "
                             "running stats would chain per sub-batch)")
        self._setup_input_s2d()
        self._reorder_relu_pool()
        self._fuse_sibling_convs()
        # dp_overlap: the bucket plan is built lazily (after the relu ->
        # pool reorder sets the deferred-bias keys); _overlap_defer picks
        # the dp_reduce_at = apply window (local micro-steps, one
        # reduction at the apply), pure-DP only
        self._dp_plan_state = None
        self._dp_warned = set()
        defer_wanted = (
            self.update_period > 1 and not self.monitor
            and self.netcfg.extra_data_num == 0
            and self.opts.dp_reduce_at == "apply"
            and self._dp_overlap_active())
        self._overlap_defer = defer_wanted and dplib.model_size(
            self.mesh) <= 1
        if defer_wanted and not self._overlap_defer:
            self._dp_warned.add("defer_model")
            mlog.warn("dp_reduce_at = apply is pure-DP; the model mesh "
                      "axis reduces every micro-step instead "
                      "(dp_reduce_at = step semantics)")
        # run header: the record binding the stream to the config it
        # measures
        self.metrics.emit(
            "run", updater=self.netcfg.updater_type,
            batch_size=self.batch_size, dtype=str(self.dtype).split(".")[-1],
            mesh=dict(self.mesh.axes) if self.mesh is not None
            else {"data": 1}, monitor=self.monitor,
            monitor_interval=self.monitor_interval,
            monitor_nan=self.monitor_nan, engine_opts=self.opts.snapshot())

    def _reorder_relu_pool(self) -> None:
        """Peephole (``pool_relu_reorder = 1``, the JAX package's
        ``_reorder_relu_pool``): a relu whose output feeds only a max
        pool moves after the pool (max(relu(x)) == relu(max(x)); the
        gradients agree a.e.), so the pool can take the relu-fused
        kernel.  When the relu's producer is a biased conv whose output
        feeds only that relu, and the conv is not of the fast-wgrad
        class (whose one wgrad computes db), its bias add moves to the
        pooled tensor too (max(z + b) == max(z) + b).  Skipped for
        shared layer instances and eval nodes.  The relu's node then
        holds the pre-activation and the conv's node the bias-less
        output: ``_read_fixups`` records what a call-time read of either
        must add back.  (A conv fed by ``input_s2d`` is not of the
        fast-wgrad class: it is a stride-1 conv.)"""
        from ..layers.activation import ReluLayer
        from ..layers.conv import ConvolutionLayer, MaxPoolingLayer
        from ..ops.nn import use_fast_wgrad
        self._read_fixups = {}
        if self.opts.pool_relu_reorder != "1":
            return
        conns = self.net.connections
        uses: Dict[int, int] = {}
        for c in conns:
            uses[id(c.layer)] = uses.get(id(c.layer), 0) + 1

        def last_writer(node, before):
            return next((j for j in range(before - 1, -1, -1)
                         if node in conns[j].nindex_out), None)

        def readers_after(node, start):
            return [j for j in range(start + 1, len(conns))
                    if node in conns[j].nindex_in]

        for i, c in enumerate(conns):
            if type(c.layer) is not MaxPoolingLayer or uses[id(c.layer)] > 1:
                continue
            v = c.nindex_in[0]
            j = last_writer(v, i)
            if j is None or type(conns[j].layer) is not ReluLayer:
                continue
            relu = conns[j]
            if (uses[id(relu.layer)] > 1 or v in self.eval_node_ids
                    or readers_after(v, j) != [i]):
                continue
            self_loop = relu.nindex_in == relu.nindex_out
            relu.layer.defer_to_pool = True
            c.layer.relu_after = True
            self._read_fixups[v] = ("relu", None)
            k = last_writer(v if self_loop else relu.nindex_in[0], j)
            if k is None:
                continue
            conv = conns[k]
            cnode = conv.nindex_out[0]
            if (type(conv.layer) is ConvolutionLayer
                    and not conv.layer.param.no_bias
                    and uses[id(conv.layer)] == 1
                    and readers_after(cnode, k) == ([j, i] if self_loop
                                                    else [j])
                    and cnode not in self.eval_node_ids
                    and conv.nindex_in != conv.nindex_out
                    and (conv.layer.s2d_input or not use_fast_wgrad(
                        self.net.node_shapes[conv.nindex_in[0]][1],
                        conv.layer.param.stride, conv.layer.param.num_group,
                        self.opts))):
                conv.layer.defer_bias = 1
                c.layer.deferred_bias_key = conv.param_key
                self._read_fixups[cnode] = ("bias", conv.param_key)
                self._read_fixups[v] = ("relu", conv.param_key)

    def _fuse_sibling_convs(self) -> None:
        """Peephole (``conv_sibling_fuse = 1``, the JAX package's
        ``_fuse_sibling_convs``): convs that read the same value (split
        outputs alias their input) with the same geometry, ungrouped,
        run as one conv whose weights join on the output channels, at
        the first member's place (``Network._forward_fused``); an
        inception module's three 1x1 reduce convs become one.  Each
        member keeps its parameters, updater state and snapshot layout.
        A member that rebinds a node written before it, a shared layer,
        a space-to-depth conv and a conv whose bias moved to a pool stay
        apart."""
        from ..layers.conv import ConvolutionLayer
        from ..layers.shape_ops import SplitLayer
        self.net.fuse_groups = {}
        self.net.fuse_skip = frozenset()
        if self.opts.conv_sibling_fuse != "1":
            return
        conns = self.net.connections
        uses: Dict[int, int] = {}
        for c in conns:
            uses[id(c.layer)] = uses.get(id(c.layer), 0) + 1

        def eligible(c):
            return (type(c.layer) is ConvolutionLayer
                    and uses[id(c.layer)] == 1
                    and len(c.nindex_in) == 1 and len(c.nindex_out) == 1
                    and c.nindex_in != c.nindex_out
                    and c.layer.param.num_group == 1
                    and not c.layer.space_to_depth
                    and not c.layer.s2d_input
                    and not c.layer.defer_bias)

        def writers_before(node, before):
            return [j for j in range(before) if node in conns[j].nindex_out]

        def value_id(v, before):
            """Node ``v``'s value at position ``before``: a split's
            outputs are its input's value."""
            w = writers_before(v, before)
            if not w:
                return ("in", v)
            j = w[-1]
            if type(conns[j].layer) is SplitLayer \
                    and len(conns[j].nindex_in) == 1:
                return value_id(conns[j].nindex_in[0], j)
            return ("conn", j)

        groups: Dict[tuple, List[int]] = {}
        for i, c in enumerate(conns):
            if not eligible(c) or writers_before(c.nindex_out[0], i):
                continue
            p = c.layer.param
            key = (value_id(c.nindex_in[0], i), p.kernel_height,
                   p.kernel_width, p.stride, p.pad_y, p.pad_x, p.no_bias)
            groups.setdefault(key, []).append(i)
        fuse = {m[0]: m for m in groups.values() if len(m) > 1}
        self.net.fuse_groups = fuse
        self.net.fuse_skip = frozenset(j for m in fuse.values()
                                       for j in m[1:])
        if fuse:
            mlog.info(f"conv_sibling_fuse: {len(fuse)} groups "
                      f"({sum(len(m) for m in fuse.values())} convs)")

    def _setup_input_s2d(self) -> None:
        """``input_s2d = 1``: the data node must feed one ungrouped
        strided conv, which then takes its input in space-to-depth form
        (:meth:`stage_input`) as a stride-1 conv."""
        from ..layers.conv import ConvolutionLayer
        from ..ops.nn import conv_out_size
        self._s2d_args = None
        if not self.input_s2d:
            return
        consumers = [c for c in self.net.connections if 0 in c.nindex_in]
        assert len(consumers) == 1, \
            "input_s2d: the data node must feed exactly one layer"
        layer = consumers[0].layer
        p = getattr(layer, "param", None)
        assert (isinstance(layer, ConvolutionLayer) and p.stride > 1
                and p.num_group == 1 and not layer.space_to_depth), (
            "input_s2d: the first layer must be an ungrouped strided conv")
        _, c, h, w = self.net.node_shapes[0]
        layer.s2d_input = 1
        self._s2d_args = (p.stride, p.kernel_height, p.kernel_width,
                          conv_out_size(h, p.kernel_height, p.stride,
                                        p.pad_y),
                          conv_out_size(w, p.kernel_width, p.stride,
                                        p.pad_x), p.pad_y, p.pad_x)

    def stage_input(self, x: torch.Tensor) -> torch.Tensor:
        """The data node's (n, c, h, w) tensor as the first layer takes
        it: under ``input_s2d = 1`` its space-to-depth form (the JAX
        package's ``_s2d_transform``, made once a batch outside the
        step); a tensor already in that form passes unchanged."""
        if self._s2d_args is None:
            return x
        from ..ops.nn import s2d_input
        s, kh, kw, oh, ow, py, px = self._s2d_args
        if x.shape[1] == self.net.node_shapes[0][1] * s * s:
            if x.dtype == torch.uint8 and (py or px):
                raise ValueError(
                    "input_s2d: pre-s2d u8 delivery is unsupported for a "
                    "padded first conv (u8 can only encode padding as raw "
                    "0, which normalises to (0 - mean) * scale instead of "
                    "the zeros the reference pads with); deliver plain u8 "
                    "batches or normalised float32")
            return x
        return s2d_input(self._normalize_input(x), s, kh, kw, oh, ow, py,
                         px)[0]

    def _normalize_input(self, x: torch.Tensor) -> torch.Tensor:
        """Device-side normalisation of a raw u8 batch (``output_u8 = 1``):
        ``(x - mean_value[c]) * scale`` in float32, the host iterators'
        SetData rule (the JAX package's ``_normalize_input``); the mean
        repeats over the (c, sy, sx) channels of a batch delivered in
        space-to-depth form.  Other dtypes pass unchanged."""
        if x.dtype != torch.uint8:
            return x
        x = x.float()
        if self.input_mean is not None:
            n = self.input_mean.size
            if self._s2d_args is not None \
                    and x.shape[-3] == n * self._s2d_args[0] ** 2:
                n *= self._s2d_args[0] ** 2
            key = (str(x.device), n)
            mean = self._mean_dev.get(key)
            if mean is None:
                mean = torch.from_numpy(np.repeat(
                    self.input_mean, n // self.input_mean.size)).to(x.device)
                self._mean_dev[key] = mean
            x = x - mean.reshape(1, -1, 1, 1)
        if self.input_scale != 1.0:
            x = x * self.input_scale
        return x

    def load_model(self, path: str, validated: bool = False) -> None:
        """Load a ``.model`` or a ``NNNN.ckpt`` directory written by either
        package.  The session's config is re-applied on top of the
        snapshot's, as in the JAX package (later pairs win); optimizer
        state in the snapshot is installed at the first update, and a
        pending gradient window (the ``acc`` shard) is restored.  The
        counters and the rng come from the snapshot's ``train_state``
        when it has one (set after ``_post_build``, which resets them);
        a ``.model`` without one gets ``sample_counter`` from the epoch.
        ``validated``: the caller has just checked the directory's
        checksums."""
        mlog.set_silent(self.silent)
        self.opt_state = None
        header, params, buffers, opt, acc = read_snapshot(path, validated)
        netcfg = NetConfig.from_dict(header["net"])
        netcfg.defcfg = list(netcfg.defcfg) + [
            (k, v) for (k, v) in self.cfg if not k.startswith("layer[")]
        for k, v in self.cfg:
            if k == "updater":
                netcfg.updater_type = v
        self._build_net(netcfg)
        dtypes = header.get("dtypes") or {}
        self.set_state(*params_from_jax(params, buffers, dtypes))
        self._post_build()
        if opt is not None:
            self._opt_host = opt_state_from_jax(opt)
        if acc is not None:
            self._grad_acc = {k: {t: v.to(self.device) for t, v in g.items()}
                              for k, g in _torch_group(acc, "acc",
                                                       dtypes).items()}
            for pkey, tag in self._sharded_leaves():
                g = self._grad_acc.get(pkey, {})
                if tag in g:
                    g[tag] = self._rank_opt(pkey, tag, g[tag])
            if self._overlap_defer and self.mesh.axis_index("data"):
                # the file holds the window's global sum; a local
                # accumulator of dp_reduce_at = apply is reduced once at
                # the apply, so one rank carries it
                for g in self._grad_acc.values():
                    for v in g.values():
                        v.zero_()
        extra = header.get("extra") or {}
        self.epoch_counter = header["epoch"]
        self.round = extra.get("round", 0)
        ts = extra.get("train_state")
        if ts is not None:
            self.set_train_state(ts)
        else:
            self.sample_counter = self.epoch_counter * self.update_period
        self.loaded_extra = dict(extra)

    def copy_model_from(self, path: str) -> None:
        """``task = finetune``: copy the weights of every layer whose name
        (the parameter key after its ``NN-`` prefix) and tag shapes match
        a layer of the ``.model`` or ``.ckpt`` at ``path``, in this net's
        dtypes, and re-derive the float32 masters (the JAX package's
        ``copy_model_from``, reference CopyModelFrom)."""
        _, params, _, _, _ = read_snapshot(path)
        by_name = {k.split("-", 1)[1]: flat_tags(v)
                   for k, v in params.items()}
        copied = []
        for pkey, group in self.params.items():
            name = pkey.split("-", 1)[1]
            src = by_name.get(name)
            if src is not None and all(
                    t in src and tuple(src[t].shape) == tuple(p.shape)
                    for t, p in group.items()):
                self.params[pkey] = {
                    t: torch.from_numpy(np.array(src[t], np.float32))
                    .to(self.device, p.dtype) for t, p in group.items()}
                copied.append(name)
        self._slice_params()
        if self.opt_state is not None:
            self._refresh_masters()
        self.copied_layers = copied
        mlog.info(f"copy_model_from: copied layers {copied}")

    def set_state(self, params: Params, buffers: Params) -> None:
        """Install parameters (e.g. from :func:`params_from_jax`) on the
        trainer's device, keeping their dtypes."""
        to = lambda tree: {k: {t: v.to(self.device) for t, v in g.items()}
                           for k, g in tree.items()}
        self.params = to(params)
        self.buffers = to(buffers)
        self._slice_params()
        if self.opt_state is not None:
            self._refresh_masters()

    # ----------------------------------------------------------- weights IO
    def _resolve_param_key(self, layer_name: str) -> str:
        for conn in self.net.connections:
            if conn.param_key.split("-", 1)[1] == layer_name:
                return conn.param_key
        raise KeyError(f"unknown layer name {layer_name!r}")

    def _leaf_tag(self, pkey: str, tag: str, layer_name: str) -> str:
        """A tag as the JAX package addresses it (``wmat``, or
        ``master:wmat`` for a pairtest side) -> the port's flat tag."""
        flat = tag.replace(":", "/")
        if flat not in self.params.get(pkey, {}):
            raise KeyError(f"layer {layer_name!r} has no tag {tag!r}; "
                           f"available: {sorted(self.params.get(pkey, {}))}")
        return flat

    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        """A layer's parameter as float32 numpy (the JAX package's
        ``get_weight``; ``KeyError`` for an unknown layer or tag)."""
        pkey = self._resolve_param_key(layer_name)
        flat = self._leaf_tag(pkey, tag, layer_name)
        p = self._logical_params()[pkey][flat]
        return p.detach().float().cpu().numpy()

    def set_weight(self, value: np.ndarray, layer_name: str,
                   tag: str) -> None:
        """Write a layer's parameter in place, in its dtype, and re-derive
        the float32 masters so the next update does not revert it."""
        pkey = self._resolve_param_key(layer_name)
        p = self.params[pkey][self._leaf_tag(pkey, tag, layer_name)]
        # a copy: the C ABI passes read-only views of its caller's memory
        value = np.array(value, np.float32)
        if tuple(p.shape) != value.shape:
            raise ValueError(f"set_weight: shape mismatch {tuple(p.shape)} "
                             f"vs {value.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(value).to(p.device, p.dtype))
        if self.opt_state is not None:
            self._refresh_masters()

    def set_opt_state(self, opt: Dict) -> None:
        """Install optimizer state (e.g. from :func:`opt_state_from_jax`)
        on the trainer's device; on a mesh the logical arrays are cut to
        this rank's part (its ZeRO slice, its model shard)."""
        self.opt_state = {k: {t: {n: self._rank_opt(k, t, a).to(
                                  self.device, torch.float32)
                                  for n, a in st.items()}
                              for t, st in g.items()}
                          for k, g in opt.items()}
        self._opt_host = None

    def _refresh_masters(self) -> None:
        """Re-derive the float32 masters from the params after a direct
        parameter write, so the next update does not revert it."""
        for pkey, group in self.params.items():
            for tag, p in group.items():
                st = self.opt_state[pkey][tag]
                if "w32" in st:
                    st["w32"] = self._opt_view(pkey, tag, p).detach() \
                        .float().clone()

    def _ensure_opt_state(self) -> None:
        if self.opt_state is not None:
            return
        if self._opt_host is not None:
            self.set_opt_state(self._opt_host)
            return
        self.opt_state = {pkey: {tag: self.updater.make_state(
                                     self._opt_view(pkey, tag, p))
                                 for tag, p in g.items()}
                          for pkey, g in self.params.items()}

    # ---------------------------------------------------------- checkpoints
    def train_state(self) -> Dict[str, Any]:
        """The non-array state exact resume needs: the counters, the
        port's rng, the ``torch.Generator`` state (``torch_rng_state``,
        hex bytes, which the JAX package ignores), and the JAX package's
        keys for its rng, ``rng_key`` as ``PRNGKey(seed)`` makes it.
        That key is the JAX package's live key in any run that never
        rolled back; after a rollback (:meth:`reseed_rng`) the port's
        stream is the generator's state, reseeded, and no JAX key draws
        that stream, so ``rng_key`` stays the seed's and the generator
        state alone carries the resume."""
        return {"sample_counter": int(self.sample_counter),
                "epoch_counter": int(self.epoch_counter),
                "round": int(self.round), "seed": int(self.seed),
                "rng_key": jax_rng_key(int(self.seed)),
                "rng_dtype": "uint32",
                "torch_rng_state": self.rng.get_state().numpy()
                .tobytes().hex()}

    def set_train_state(self, st: Dict[str, Any]) -> None:
        """Restore :meth:`train_state`.  A snapshot without the torch rng
        state (one the JAX package wrote), or with one of a generator on
        another device type, re-seeds the generator from ``seed``."""
        self.sample_counter = int(st["sample_counter"])
        self.epoch_counter = int(st["epoch_counter"])
        self.round = int(st["round"])
        hexed = st.get("torch_rng_state")
        state = None if hexed is None else torch.frombuffer(
            bytearray.fromhex(hexed), dtype=torch.uint8)
        if state is not None and state.numel() == self.rng.get_state().numel():
            self.rng.set_state(state)
            return
        if state is not None:
            mlog.warn("snapshot rng state is of another device's "
                      "generator; re-seeding the rng from seed")
        self.rng.manual_seed(self.seed)

    def reseed_rng(self, salt: int) -> None:
        """Fold ``salt`` into the generator: the rollback path's "reseed
        past the bad window".  The new seed is a hash of the generator's
        current state and the salt (deterministic), so the retried rounds
        draw other dropout / augment masks, and a later snapshot carries
        the reseeded state in :meth:`train_state`, so its own resume is
        exact."""
        import hashlib
        digest = hashlib.sha256(self.rng.get_state().numpy().tobytes()
                                + int(7919 + salt).to_bytes(8, "little"))
        self.rng.manual_seed(int.from_bytes(digest.digest()[:8], "little")
                             & ((1 << 63) - 1))

    def checkpoint_payload(self, *, with_opt: bool = True,
                           extra_state: Optional[Dict] = None
                           ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                      Dict[str, Any]]:
        """One snapshot's (shards, manifest meta), as the JAX package
        writes them: flat host-array shards ``params``, ``buffers`` (when
        there are any), ``opt`` (under ``with_opt``, once there is
        optimizer state) and ``acc`` (the summed gradients of a window
        that a round boundary cut, ``update_period > 1``), and the meta
        (``net``, ``epoch``, ``has_opt_state``, ``dtypes``, ``extra``:
        the round, :meth:`train_state` and ``extra_state``).  Optimizer
        state not made yet is made here, as the first update would make
        it, so a snapshot before the first step carries it as the JAX
        package's does.  Runs on the train thread: the arrays are
        independent host copies, safe to hand to the async writer.  On a
        mesh every rank calls it (the shards of ZeRO and model-sharded
        leaves are gathered into the logical arrays the file holds, the
        same file one device writes); rank 0 writes it."""
        dtypes: Dict[str, str] = {}
        shards = {"params": serializer.flatten_tree(
            {"params": _host_tree(self._logical_params())}, dtypes)}
        buf = serializer.flatten_tree(
            {"buffers": _host_tree(self.buffers)}, dtypes)
        if buf:
            shards["buffers"] = buf
        if with_opt:
            self._ensure_opt_state()
            shards["opt"] = serializer.flatten_tree(
                {"opt": _host_tree(self._logical_opt())}, dtypes)
        if self.sample_counter % self.update_period \
                and self._grad_acc is not None:
            shards["acc"] = serializer.flatten_tree(
                {"acc": _host_tree(self._global_acc())}, dtypes)
        extra = {"round": int(self.round),
                 "train_state": self.train_state()}
        if extra_state:
            extra.update(extra_state)
        meta = {"net": self.netcfg.to_dict(),
                "epoch": int(self.epoch_counter),
                "has_opt_state": with_opt, "dtypes": dtypes,
                "extra": extra}
        return shards, meta

    def _global_acc(self) -> Dict:
        """The pending gradient window as the file holds it: the global
        sum (a ``dp_reduce_at = apply`` window's local sums reduced over
        ``data``) of logical arrays."""
        out = {}
        for pkey, g in self._grad_acc.items():
            out[pkey] = {}
            for tag, v in g.items():
                if self._overlap_defer:
                    v = meshlib.all_reduce(v.clone(), self.mesh, "data")
                out[pkey][tag] = self._logical(pkey, tag, v)
        return out

    def save_model(self, path: str, with_opt_state: bool = False,
                   extra_state: Optional[Dict] = None,
                   write: bool = True) -> None:
        """Write a legacy ``.model`` (atomically), with the optimizer state
        under ``with_opt_state`` (made here if no update has made it), and
        the round, :meth:`train_state` and ``extra_state`` in its header's
        extra.  On a mesh every rank calls it (the logical arrays are
        gathered, :meth:`checkpoint_payload`), the ranks that do not write
        the file with ``write = False``."""
        extra = {"round": int(self.round), "train_state": self.train_state()}
        if extra_state:
            extra.update(extra_state)
        if with_opt_state:
            self._ensure_opt_state()
        params = self._logical_params()
        opt = self._logical_opt() if with_opt_state else None
        if not write:
            return
        serializer.save_model(
            path, net_structure=self.netcfg.to_dict(),
            epoch=self.epoch_counter, params=params,
            buffers=self.buffers, opt_state=opt, extra_meta=extra)

    # -------------------------------------------------------------- staging
    def _host_tensor(self, a, keep_u8: bool = False) -> torch.Tensor:
        """A host array as a tensor on the trainer's device: float32 (a u8
        data batch stays u8 under ``keep_u8``), copied on the card from
        pinned memory without blocking the calling thread's stream."""
        arr = np.asarray(a)
        if not (keep_u8 and arr.dtype == np.uint8):
            arr = arr.astype(np.float32, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def stage_batch(self, batch):
        """Host :class:`~..io.data.DataBatch` -> device-resident
        :class:`~..io.device_prefetch.StagedBatch`, on the calling
        thread's current stream (the prefetcher's copy stream on its
        producer thread): the transfer (u8 data stays u8), the
        ``input_s2d`` staging transform, float32 labels and side inputs
        (token ids stay float32), the tail loss mask.  The copies are
        asynchronous; on the card an event recorded after them is what a
        consumer's stream waits on (:meth:`StagedBatch.handover`)."""
        from ..io.device_prefetch import StagedBatch
        t0 = time.perf_counter()
        # on a data mesh this rank stages its rows of the batch only, on
        # a seq axis that splits the positions its block of them
        n = np.asarray(batch.label).shape[0]
        rows = self._rows(n) if self._data_split() else slice(0, n)
        label_host = np.asarray(batch.label)[rows]
        data = self._host_tensor(
            np.asarray(batch.data)[rows][..., self._position_block()],
            keep_u8=True)
        if self._s2d_args is not None:
            data = self.stage_input(data)
        label = self._host_tensor(self._local_label(label_host))
        extras = tuple(self._host_tensor(np.asarray(e)[rows])
                       for e in getattr(batch, "extra_data", None) or ())
        n_padd = int(getattr(batch, "tail_mask_padd", 0))
        mask = None
        if n_padd:
            # tail-batch replica padding trains nothing (DataBatch),
            # wherever its rows fall among the ranks
            host_mask = np.ones((n,), np.float32)
            host_mask[n - n_padd:] = 0.0
            mask = torch.from_numpy(host_mask[rows]).to(self.device)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return StagedBatch(
            data=data, label=label, label_host=label_host,
            index=batch.index, num_batch_padd=int(batch.num_batch_padd),
            tail_mask_padd=n_padd, extra_data=extras, mask=mask,
            h2d_sec=time.perf_counter() - t0, ready=ready,
            global_rows=n if self._data_split() else 0)

    def _position_block(self) -> slice:
        """This rank's block of the input's positions, its last dim (all
        of it unless the ``seq`` axis splits the positions)."""
        s = self.net.node_shapes[0][3]
        if not self.seq_split:
            return slice(0, s)
        n = self.mesh.axis_size("seq")
        i = self.mesh.axis_index("seq")
        return slice(i * s // n, (i + 1) * s // n)

    def _local_label(self, label):
        """A (rows, label width) host label vector as this rank holds it:
        each per-position field (one value a position: ``label``,
        ``segment``, ``position`` of a packed LM) cut to the rank's block
        of positions, the other fields whole, in the same order
        (:meth:`label_info` reads the layout)."""
        if not self.seq_split:
            return label
        s = self.net.node_shapes[0][3]
        blk = self._position_block()
        return np.concatenate(
            [label[:, a + blk.start:a + blk.stop] if b - a == s
             else label[:, a:b] for _, a, b in self._label_fields], 1)

    def _local_fields(self) -> List[Tuple[str, int, int]]:
        """The label fields' layout of a :meth:`_local_label` vector."""
        s = self.net.node_shapes[0][3]
        blk = self._position_block()
        out, at = [], 0
        for name, a, b in self._label_fields:
            w = blk.stop - blk.start if b - a == s else b - a
            out.append((name, at, at + w))
            at += w
        return out

    def _staged(self, batch):
        """The batch staged and safe to read on the current stream: a
        host batch is staged here, a prefetched one handed over."""
        from ..io.device_prefetch import StagedBatch
        if not isinstance(batch, StagedBatch):
            batch = self.stage_batch(batch)
        return batch.handover()

    # ------------------------------------------------------------ training
    def _batch_tensors(self, sb) -> Tuple[Dict[int, torch.Tensor],
                                          LabelInfo]:
        """A handed-over staged batch's input nodes and label fields."""
        inputs = {0: sb.data}
        for i, e in enumerate(sb.extra_data):
            inputs[1 + i] = e
        info = self.label_info(sb.label)
        info.mask = sb.mask
        return inputs, info

    def loss_and_grads(self, batch) -> Tuple[torch.Tensor, Dict]:
        """The summed, scaled loss of one batch and its gradient for
        every parameter (same nesting as ``params``); the buffers are
        left as they were."""
        loss, grads, _, _ = self._loss_grads_outs(
            *self._batch_tensors(self._staged(batch)))
        return loss, grads

    def _ctx(self, labels: Optional[LabelInfo], epoch: int
             ) -> ForwardContext:
        return ForwardContext(train=True, opts=self.opts, labels=labels,
                              loss_scale=self.loss_scale, rng=self.rng,
                              epoch=epoch, mesh=self.mesh,
                              seq_split=self.seq_split)

    def _loss_grads_outs(self, inputs: Dict[int, torch.Tensor],
                         labels: LabelInfo, epoch: Optional[int] = None,
                         dp: Optional[str] = None, acc: Optional[Dict] = None
                         ) -> Tuple[torch.Tensor, Dict, Dict, Dict]:
        """(loss, grads, {eval node: its training-forward output}, new
        buffers).  ``dp`` (:meth:`_dp_mode`) picks the backward of a
        data-parallel step: ``overlap`` / ``fold`` reduce the gradients
        bucket by bucket from the backward (``fold`` with the local
        window ``acc`` folded in first), ``local`` leaves them local;
        otherwise (``implicit`` or no mesh) the caller reduces them.
        Model-sharded leaves are gathered where the forward reads them
        and their gradients come back as shards."""
        epoch = self.epoch_counter if epoch is None else epoch
        if self._pipelined:
            return self._pipe_loss_grads(inputs, labels, epoch)
        leaves = [(k, t, p) for k, g in self.params.items()
                  for t, p in g.items()]
        for _, _, p in leaves:
            p.requires_grad_(True)
        diags: Dict[str, torch.Tensor] = {}
        own = self.params
        self.params = self._run_params()
        try:
            with record_function("train_forward"):
                if self.remat:
                    nodes, buffers, losses = self._remat_forward(
                        inputs, labels, epoch, diags)
                elif self.batch_split > 1:
                    nodes, buffers, losses = self._split_forward(
                        inputs, labels, epoch, diags)
                else:
                    ctx = self._ctx(labels, epoch)
                    nodes, buffers = self.net.run(self.params, self.buffers,
                                                  inputs, ctx)
                    losses = ctx.losses
                    diags = ctx.diagnostics
                # the step's diagnostics (pairtest errors), on the device
                self.last_diags = diags
                if not losses:
                    raise RuntimeError("network has no loss layer; cannot "
                                       "train")
                total = sum(losses[1:], losses[0])
            # a probe reads the first forward only, never a remat
            # segment's recompute in the backward
            self.net.mem_probe = None
            with record_function("train_backward"):
                if dp in ("overlap", "fold", "local"):
                    out = self._overlap_backward(total, leaves, dp, acc)
                else:
                    grads = torch.autograd.grad(
                        total, [p for _, _, p in leaves])
                    out = {}
                    for (k, t, _), g in zip(leaves, grads):
                        out.setdefault(k, {})[t] = g
        finally:
            self.params = own
            self.net.mem_probe = None
            for _, _, p in leaves:
                p.requires_grad_(False)
        outs = {n: materialize(nodes[n]).detach() for n in self.eval_node_ids}
        return total.detach(), out, outs, buffers

    def _split_forward(self, inputs, labels: LabelInfo, epoch: int,
                       diags: Dict[str, torch.Tensor]):
        """``batch_split = K``: K sub-batch chains through the net, their
        loss terms summed (the scale stays 1 / batch, so the total is the
        unsplit batch's), the eval nodes' rows concatenated; each chain
        draws its masks after the one before it.  ``diags`` gets each
        diagnostic's largest value over the chains."""
        if len(inputs) != 1:
            raise ValueError("batch_split: extra-data inputs unsupported")
        data, k = inputs[0], self.batch_split
        if data.shape[0] % k:
            raise ValueError(f"batch_split = {k} does not divide the batch "
                             f"of {data.shape[0]}")
        step = data.shape[0] // k
        losses, parts = [], []
        for j in range(k):
            sl = slice(j * step, (j + 1) * step)
            ctx = self._ctx(LabelInfo(
                fields={n: f[sl] for n, f in labels.fields.items()},
                mask=None if labels.mask is None else labels.mask[sl]), epoch)
            nodes, _ = self.net.run(self.params, self.buffers,
                                    {0: data[sl]}, ctx)
            losses += ctx.losses
            for k, v in ctx.diagnostics.items():
                diags[k] = v if k not in diags else torch.maximum(diags[k], v)
            parts.append({n: materialize(nodes[n]) for n in self.eval_node_ids})
        nodes = [None] * self.net.cfg.num_nodes
        for n in self.eval_node_ids:
            nodes[n] = torch.cat([p[n] for p in parts])
        return nodes, self.buffers, losses

    def _remat_forward(self, inputs, labels: LabelInfo, epoch: int,
                       diags: Dict[str, torch.Tensor]):
        """``remat = K``: the body's K segments
        (``pipeline_net.partition_network``) each run under
        ``torch.utils.checkpoint``, which keeps only a segment's frontier
        and runs it again in the backward; the trailing loss layers run
        after them.  A segment's loss terms (mid-body heads) leave it as
        an output.  The recompute redraws the masks of the forward: the
        generator's state before the segment is set for it, and the
        state after put back (``torch.utils.checkpoint`` restores only
        the global generators).  Connections run one by one, without
        the sibling-fuse and virtual-concat peepholes, as in the JAX
        package's segments; an armed ``mem_probe`` reads the allocator
        after each of them in the forward (the backward's recompute
        runs with none).  ``diags`` gets the diagnostics of the trailing
        layers only: a segment's stay inside its checkpoint, as in the
        JAX package."""
        from torch.utils.checkpoint import checkpoint
        from . import pipeline_net
        net = self.net
        if len(inputs) != 1:
            raise ValueError("remat: extra-data inputs unsupported")
        if self._remat_partition is None:
            self._remat_partition = pipeline_net.partition_network(
                net, self.remat)
        stages, body_end = self._remat_partition
        want = torch.float32 if 0 in net.id_inputs else net.dtype
        nodes = {0: inputs[0].to(want)}
        fns = pipeline_net.make_stage_fns(
            net, stages, lambda m: self._ctx(labels, epoch))

        def segment(fn):
            def run(*acts):
                out, loss = fn(self.params, acts,
                               torch.zeros((), device=acts[0].device))
                return out + (loss,)
            return run

        body_loss = None
        for fn, (lo, hi) in zip(fns, stages):
            ins = pipeline_net.frontier_nodes(net, lo)
            res = checkpoint(_replaying(segment(fn), self.rng),
                             *[nodes[n] for n in ins], use_reentrant=False)
            nodes = dict(zip(pipeline_net.frontier_nodes(net, hi), res[:-1]))
            body_loss = res[-1] if body_loss is None else body_loss + res[-1]
        ctx = self._ctx(labels, epoch)
        env = pipeline_net.run_conns(net, self.params, body_end,
                                     len(net.connections), nodes, ctx)
        for nid in self.eval_node_ids:
            assert nid in env, ("remat: train-metric eval nodes must sit at "
                                "or after the last segment boundary")
        node_list = [env.get(n) for n in range(net.cfg.num_nodes)]
        diags.update(ctx.diagnostics)
        return node_list, self.buffers, ctx.losses + [body_loss]

    # ------------------------------------------------------------ pipeline
    @property
    def _pipelined(self) -> bool:
        return self.mesh is not None and self.mesh.axis_size("pipe") > 1

    @property
    def _n_micro(self) -> int:
        return self.pipe_microbatch or 2 * self.mesh.axis_size("pipe")

    @property
    def pipe_bubble_frac(self) -> float:
        """Analytic pipeline-bubble share of the step, ``(S-1)/(M+S-1)``
        (S stages, M microbatches): the fraction of schedule ticks a
        stage idles during fill and drain; 0.0 on a mesh without a pipe
        axis.  Stamped on step and round records so the goodput ledger
        carves ``pipe_bubble`` out of dispatch (monitor/ledger.py)."""
        if not self._pipelined:
            return 0.0
        n = self.mesh.axis_size("pipe")
        return (n - 1) / (self._n_micro + n - 1)

    def _pipe_setup(self):
        """The graph's partition into the pipe axis's stages, made once
        (with its log line)."""
        if self._pipe_partition is None:
            from . import pipeline_net
            n_stage = self.mesh.axis_size("pipe")
            stages, body_end = pipeline_net.partition_network(
                self.net, n_stage)
            if not mlog.is_silent():
                desc = ", ".join(
                    "+".join(self.net.connections[j].layer.type_names[0]
                             for j in range(s0, s1))
                    for s0, s1 in stages)
                mlog.info(f"pipeline: {n_stage} stages [{desc}]")
            self._pipe_partition = (stages, body_end)
        return self._pipe_partition

    def _pipe_bucket_plan(self):
        """The bucket plan of ``dp_overlap = 1`` composed with the pipe
        axis under 1F1B, or None (one whole-tree reduction after the
        schedule): each stage's param keys, the loss tail's with the last
        stage's, in ``dp_bucket_mb``-bounded buckets tagged with the
        stage whose last backward makes them final.  A key several stages
        read belongs to the lowest of them, which finishes last (the JAX
        package's ``_pipe_bucket_plan``)."""
        if self.opts.dp_overlap != "1" or self.pipe_schedule != "1f1b" \
                or dplib.data_size(self.mesh) < 2:
            return None
        if self._pipe_bucket_state is None:
            from ..parallel import overlap
            stages, body_end = self._pipe_setup()
            n_stage = len(stages)
            owner: Dict[str, int] = {}
            for s, (s0, s1) in enumerate(stages):
                for key in overlap._keys_read(self.net, s0, s1, self.params):
                    owner.setdefault(key, s)
            for key in overlap._keys_read(self.net, body_end,
                                          len(self.net.connections),
                                          self.params):
                owner.setdefault(key, n_stage - 1)
            logical = self._logical_bytes()
            bucket_bytes = max(float(self.opts.dp_bucket_mb) * 2 ** 20, 1.0)
            buckets = []
            for s in range(n_stage):
                # reverse layer order within the stage, chunked to the
                # wire-size target
                cur, acc = [], 0.0
                for key in [k for k in reversed(list(owner))
                            if owner[k] == s]:
                    cur.append(key)
                    acc += logical[key]
                    if acc >= bucket_bytes:
                        buckets.append((tuple(cur), s))
                        cur, acc = [], 0.0
                if cur:
                    buckets.append((tuple(cur), s))
            self._pipe_bucket_state = (tuple(buckets),)
            if not mlog.is_silent():
                mlog.info(
                    "pipe dp_overlap: %d bucket(s) over %d stages "
                    "(KiB: %s), reduce_dtype=%s — (pipe, data) psums "
                    "issue at cooldown grad-ready ticks" % (
                        len(buckets), n_stage,
                        ",".join(str(sum(logical[k] for k in ks) // 1024)
                                 for ks, _ in buckets),
                        self.opts.dp_reduce_dtype))
        return self._pipe_bucket_state[0]

    def _logical_bytes(self) -> Dict[str, int]:
        """Each param group's logical bytes (model shards counted
        whole)."""
        out = {}
        for pkey, g in self.params.items():
            n = 0
            for tag, p in g.items():
                shape = self.model_sharded.get((pkey, tag), tuple(p.shape))
                n += int(np.prod(shape)) * p.element_size()
            out[pkey] = n
        return out

    def _pipe_run(self, inputs, labels: Optional[LabelInfo], epoch: int,
                  *, train: bool, node_ids: Sequence[int] = (),
                  params=None):
        """This rank's stage of a pipelined step (``train``) or eval
        forward over the batch it holds (``parallel/pipeline.py``).  The
        batch is cut into ``n_micro`` contiguous microbatches; stage
        ``s`` runs on the ranks at index ``s`` of the pipe axis, with the
        whole parameter tree (model-axis shards and a moe layer's experts
        gathered once, at the step's start); the loss tail and the nodes
        read after the last stage (``node_ids``) run on the last stage, a
        microbatch at a time, and the nodes' values reach every rank of
        the axis.  ``params`` (this rank's leaves) replaces the trainer's
        own in an eval forward.  Returns ``(run result, {node: values},
        the leaves [(pkey, tag, tensor)])``."""
        from ..parallel import pipeline
        from . import pipeline_net
        net = self.net
        stages, body_end = self._pipe_setup()
        if len(inputs) != 1:
            raise AssertionError("pipeline: extra-data inputs unsupported")
        if train and not any(c.layer.is_loss for c in net.connections):
            raise AssertionError("network has no loss layer; cannot train")
        frontier = pipeline_net.frontier_nodes(net, body_end)
        readable = self._pipe_tail_nodes()
        for nid in node_ids:
            assert nid in readable, (
                "pipeline: train-metric eval nodes must sit at or after "
                "the last stage boundary")
        n_micro = self._n_micro
        want = torch.float32 if 0 in net.id_inputs else net.dtype
        x = inputs[0].to(want)
        if x.shape[0] % n_micro:
            raise AssertionError(f"pipeline: batch {x.shape[0]} not "
                                 f"divisible by pipe_microbatch {n_micro}")
        mbl = x.shape[0] // n_micro
        # the shape-only pass (_pipe_wire) reads meta labels
        shape_pass = [False]

        def labels_of(m: int) -> Optional[LabelInfo]:
            if labels is None:
                return None
            sl = slice(m * mbl, (m + 1) * mbl)

            def cut(t):
                t = t[sl]
                return torch.empty_like(t, device="meta") \
                    if shape_pass[0] else t
            return LabelInfo(
                fields={n: cut(f) for n, f in labels.fields.items()},
                mask=None if labels.mask is None else cut(labels.mask))

        def ctx_of(m: int) -> ForwardContext:
            # no mesh: a stage computes on its rows as the JAX package's
            # stages do inside shard_map (a moe layer's capacity and load
            # balance per microbatch and data shard, every expert local)
            return ForwardContext(
                train=train, opts=self.opts, labels=labels_of(m),
                loss_scale=self.loss_scale, rng=self.rng if train else None,
                epoch=epoch)

        params = {pkey: {tag: self._logical(pkey, tag, p)
                         for tag, p in g.items()}
                  for pkey, g in (self.params if params is None
                                  else params).items()}
        leaves = [(k, t, p) for k, g in params.items() for t, p in g.items()]
        if train:
            for _, _, p in leaves:
                p.requires_grad_(True)
        fns = pipeline_net.make_stage_fns(net, stages, ctx_of)
        s = self.mesh.axis_index("pipe")
        last = s == len(stages) - 1

        def tail(p, acts, aux, m):
            ctx = ctx_of(m)
            env = pipeline_net.run_conns(net, p, body_end,
                                         len(net.connections),
                                         dict(zip(frontier, acts)), ctx)
            loss = aux
            for v in ctx.losses:
                loss = loss + v
            keep = [materialize(env[n]).detach() for n in node_ids]
            return (loss if train else None), (keep, ctx.diagnostics)

        shape_pass[0] = True
        try:
            specs, node_specs = self._pipe_wire(fns, tail, params, x[:mbl],
                                                tuple(node_ids))
        finally:
            shape_pass[0] = False
        grad_idx, reduce = None, None
        if train:
            from ..parallel.overlap import REDUCE_DTYPES, _keys_read
            mine = set(_keys_read(net, *stages[s], params))
            if last:
                mine.update(_keys_read(net, body_end, len(net.connections),
                                       params))
            grad_idx = [i for i, (k, _, _) in enumerate(leaves) if k in mine]
            buckets = self._pipe_bucket_plan()
            where = {k: [i for i, (kk, _, _) in enumerate(leaves) if kk == k]
                     for k in params}
            reduce = {
                "axes": ("pipe", "data"),
                "buckets": None if buckets is None else
                [([i for k in keys for i in where[k]], owner)
                 for keys, owner in buckets],
                "dtype": None if buckets is None
                else REDUCE_DTYPES[self.opts.dp_reduce_dtype]}
        res = pipeline.run_schedule(
            lambda acts, aux, m: fns[s](params, acts, aux, m),
            lambda m: (x[m * mbl:(m + 1) * mbl],), n_micro, specs,
            mesh=self.mesh, schedule=self.pipe_schedule, train=train,
            tail_fn=lambda acts, aux, m: tail(params, acts, aux, m),
            leaves=[p for _, _, p in leaves],
            grad_idx=grad_idx, reduce=reduce)
        if train:
            self.pipe_stats = {"live_max": res.live_max,
                               "handoffs": res.handoffs}
            self.last_diags = res.keeps[-1][1] if last and res.keeps else {}
        # every rank of the pipe axis gets the tail's node outputs
        outs = []
        for j, (shape, dt) in enumerate(node_specs):
            if last:
                v = torch.cat([k[j] for k, _ in res.keeps])
            else:
                v = torch.zeros((n_micro * shape[0],) + tuple(shape[1:]),
                                dtype=dt, device=self.device)
            outs.append(pipeline.broadcast_last(v, self.mesh, "pipe"))
        return res, dict(zip(node_ids, outs)), leaves

    def _pipe_tail_nodes(self) -> set:
        """The nodes a pipelined run can read: the last boundary's and
        the loss tail's."""
        from . import pipeline_net
        _, body_end = self._pipe_setup()
        out = set(pipeline_net.frontier_nodes(self.net, body_end))
        for c in self.net.connections[body_end:]:
            out.update(c.nindex_out)
        return out

    def _pipe_loss_grads(self, inputs, labels: LabelInfo, epoch: int):
        """A pipelined step's ``(loss, grads, eval-node outputs,
        buffers)``: the schedule's gradients, summed over (pipe, data) and
        cast to the parameters' dtypes (a model shard's slice of its
        whole gradient), and the loss, the last stage's per-microbatch
        tail totals summed in microbatch order on every rank of the pipe
        axis: one reduction under both schedules."""
        from ..parallel import pipeline
        if self.remat:
            raise AssertionError(
                "remat and mesh=pipe are mutually exclusive (the pipeline "
                "schedule already bounds live activations per stage)")
        own = [p for g in self.params.values() for p in g.values()]
        try:
            with record_function("train_pipeline"):
                res, outs, leaves = self._pipe_run(
                    inputs, labels, epoch, train=True,
                    node_ids=list(dict.fromkeys(self.eval_node_ids)))
        finally:
            for p in own:
                p.requires_grad_(False)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (k, t, _), g in zip(leaves, res.grads):
            axis, _ = self._shard_of(k, t)
            if axis is not None:
                g = dplib.axis_block(g, self.mesh, axis)
            grads.setdefault(k, {})[t] = g.to(self.params[k][t].dtype)
        loss = pipeline.total_loss(res, self.mesh)
        return loss, grads, outs, self.buffers

    def _pipe_wire(self, fns, tail, params, x0, node_ids):
        """``(specs, node specs)``: the wire spec of each stage's output
        value and the shape and dtype of each requested node a
        microbatch, from a shape-only pass of every stage and the tail on
        ``meta`` tensors (nothing launches), once per microbatch
        shape."""
        from ..analysis.graph_lint import _TraceOnMeta
        from ..parallel import pipeline
        key = (tuple(x0.shape), x0.dtype, node_ids)
        if key not in self._pipe_specs:
            meta = torch.device("meta")
            on_meta = {k: {t: torch.empty_like(p, device=meta)
                           for t, p in g.items()} for k, g in params.items()}
            with _TraceOnMeta(), torch.no_grad():
                specs = pipeline.boundary_specs(
                    [lambda a, aux, m, f=f: f(on_meta, a, aux, m)
                     for f in fns], (torch.empty_like(x0, device=meta),))
                acts = tuple(torch.empty(shape, dtype=dt, device=meta)
                             for shape, dt in specs[-1][:-1])
                _, (keep, _) = tail(on_meta, acts,
                                    torch.zeros((), device=meta), 0)
            self._pipe_specs[key] = (
                specs, [(tuple(v.shape), v.dtype) for v in keep])
        return self._pipe_specs[key]

    def update(self, batch) -> None:
        """One training step on a host :class:`~..io.data.DataBatch` or a
        staged batch; with ``eval_train`` the step's eval-node outputs go
        to the train metric (padding excluded)."""
        sb = self._staged(batch)
        outs = self.update_step(*self._batch_tensors(sb))
        if self.eval_train and self.train_metric.evals:
            self._add_batch_eval(self.train_metric,
                                 [outs[n].float() for n in
                                  self.eval_node_ids], sb)

    def update_step(self, inputs: Dict[int, torch.Tensor],
                    labels: LabelInfo) -> Dict[int, torch.Tensor]:
        """One training step on device tensors (node id -> input, label
        fields); returns the eval-node outputs of its forward."""
        self._ensure_opt_state()
        inputs, labels = self._local_rows(inputs, labels)
        inputs = {**inputs,
                  0: self.stage_input(self._normalize_input(inputs[0]))}
        self._count_shape(self._train_shapes, "train_step_traces", inputs)
        probe, self.mem_probe = self.mem_probe, None
        if probe is not None:
            probe.start()
            self.net.mem_probe = probe
        self.sample_counter += 1
        do_update = self.sample_counter % self.update_period == 0
        epoch = self.epoch_counter
        if do_update:
            self.epoch_counter += 1
        dp = self._dp_mode(do_update, len(inputs) > 1)
        acc = None
        if dp == "fold":
            acc, self._grad_acc = self._grad_acc, None
        # at one device the call is the single-device step's
        kw = {} if dp is None else {"dp": dp, "acc": acc}
        loss, grads, outs, self.buffers = self._loss_grads_outs(
            inputs, labels, epoch, **kw)
        if dp is not None:
            # the global batch's loss; the implicit step's gradients
            # summed over the token axes leaf by leaf (ZeRO leaves
            # reduce-scattered when no accumulator holds them whole)
            for ax in self._token_axes():
                loss = meshlib.all_reduce(loss.clone(), self.mesh, ax)
            if dp == "implicit":
                grads = dplib.reduce_grads(
                    grads, self.mesh, self.zero_leaves,
                    scatter=self.update_period == 1,
                    axes=self._token_axes())
        if probe is not None:
            probe.mark(BACKWARD)
        self.last_loss = loss
        if self.update_period > 1 and dp != "fold":
            if self._grad_acc is None:
                self._grad_acc = grads
            else:
                for k, g in grads.items():
                    for t, v in g.items():
                        self._grad_acc[k][t].add_(v)
            grads = self._grad_acc
            if do_update:
                self._grad_acc = None
        # monitor = 1, a tick step: the weights before the update (which
        # writes them in place) for the update norm
        tick = (self.monitor and self.monitor_interval > 0
                and self.sample_counter % self.monitor_interval == 0)
        before = ingraph.snapshot(self.params) if tick else None
        if do_update:
            if dp is not None:
                dplib.sync_replicas(
                    grads, self.mesh, lambda k, t: self._shard_of(k, t)[0])
            self.apply_update(grads, epoch)
        if probe is not None:
            probe.mark(UPDATE)
            probe.finish()
        if tick:
            self._last_monitor = ingraph.group_stats(before, grads,
                                                     self.params)
            self._monitor_tick(loss, self._last_monitor)
        return outs

    # ------------------------------------------------------- data parallel
    def _local_rows(self, inputs: Dict[int, torch.Tensor],
                    labels: LabelInfo
                    ) -> Tuple[Dict[int, torch.Tensor], LabelInfo]:
        """A whole batch (``batch_size`` rows) cut to this rank's rows on
        a data mesh, and to its block of positions where the ``seq`` axis
        splits them; a staged batch arrives cut already
        (:meth:`stage_batch`)."""
        s = self.net.node_shapes[0][3]
        cut_rows = self._data_split() \
            and inputs[0].shape[0] == self.batch_size
        cut_pos = self.seq_split and inputs[0].shape[-1] == s
        if not (cut_rows or cut_pos):
            return inputs, labels
        rows = self._rows(self.batch_size) if cut_rows else slice(None)
        if not isinstance(rows, slice):
            rows = torch.as_tensor(rows, device=inputs[0].device)
        blk = self._position_block() if cut_pos else slice(None)

        def cut(f):
            f = f[rows]
            return f[:, blk] if cut_pos and f.shape[1] == s else f
        return ({k: v[rows][..., blk] if v.shape[-1] == s else v[rows]
                 for k, v in inputs.items()},
                LabelInfo(fields={n: cut(f)
                                  for n, f in labels.fields.items()},
                          mask=None if labels.mask is None
                          else labels.mask[rows]))

    def _rows(self, n: int, d: Optional[int] = None):
        """The rows of an ``n``-row batch data rank ``d`` (this rank's by
        default) takes: its block of ``n / N``, or on a pipelined mesh
        its block of each of the ``n_micro`` contiguous microbatches the
        batch is cut into (the JAX package shards each microbatch over
        ``data``), an index array."""
        if self._pipelined:
            return dplib.micro_rows(self.mesh, n, self._n_micro, d)
        return dplib.row_slice(self.mesh, n, d)

    def _dp_mode(self, do_update: bool, extras: bool) -> Optional[str]:
        """The reduction of this step: None on one device; ``implicit``
        (all gradients after the backward; the one step of a mesh
        without a data axis); ``overlap`` (bucketed, from the backward:
        ``dp_overlap = 1``); under ``dp_reduce_at = apply`` windows,
        ``local`` micro-steps and a ``fold`` apply step; ``pipe`` on a
        pipelined mesh (the schedule reduces its own gradients over
        (pipe, data))."""
        if self._pipelined:
            if self.opts.dp_overlap == "1":
                self._dp_overlap_active()  # warns where it cannot compose
            return None if self.mesh.virtual else "pipe"
        if not self._data_split():
            if self.opts.dp_overlap == "1":
                self._dp_overlap_active()  # warns: nothing to reduce
            # a seq axis still sums, a model / expert axis still syncs
            return "implicit" if self.mesh is not None \
                and not self.mesh.virtual else None
        if extras and self.opts.dp_overlap == "1":
            self._dp_warn_once("extra-data inputs are unsupported")
            return "implicit"
        if not self._dp_overlap_active():
            return "implicit"
        if self._overlap_defer:
            return "fold" if do_update else "local"
        return "overlap"

    def _dp_warn_once(self, reason: str) -> None:
        if reason not in self._dp_warned:
            self._dp_warned.add(reason)
            mlog.warn(f"dp_overlap = 1 ignored: {reason}; using the "
                      "implicit-psum step")

    def _dp_overlap_plan(self):
        """The bucket plan (:func:`~..parallel.overlap.plan_buckets`,
        over the logical parameter sizes), built once with its log line;
        None when an eval node sits before the loss-tail frontier."""
        if self._dp_plan_state is None:
            from ..parallel import overlap
            logical = {pkey: {tag: torch.empty(
                self.model_sharded.get((pkey, tag), tuple(p.shape)),
                dtype=p.dtype, device="meta") for tag, p in g.items()}
                for pkey, g in self.params.items()}
            for (pkey, tag), (_, rows) in self.expert_sharded.items():
                p = self.params[pkey][tag]
                logical[pkey][tag] = torch.empty(
                    (rows,) + tuple(p.shape[1:]), dtype=p.dtype,
                    device="meta")
            plan = overlap.plan_buckets(
                self.net, logical, float(self.opts.dp_bucket_mb),
                tuple(dict.fromkeys(self.eval_node_ids)))
            self._dp_plan_state = (plan,)
            if plan is not None:
                sizes = [sum(overlap.group_bytes(logical[k]) for k in ks)
                         for ks in plan.stage_keys]
                n_gather = len(self.model_sharded)
                mlog.info(
                    "dp_overlap: %d buckets (KiB per bucket: %s), "
                    "reduce_dtype=%s, reduce_at=%s%s" % (
                        len(plan.stages),
                        ",".join(str(s // 1024) for s in sizes),
                        self.opts.dp_reduce_dtype, self.opts.dp_reduce_at,
                        f", model-axis gathers={n_gather} leaves"
                        if dplib.model_size(self.mesh) > 1 and n_gather
                        else ""))
        return self._dp_plan_state[0]

    def _dp_overlap_active(self) -> bool:
        """True when the bucketed, backward-overlapped reduction replaces
        the implicit one.  Each combination it cannot run falls back to
        the implicit step with a one-shot warning, in the JAX package's
        words.  On a pipe axis the 1F1B schedule issues its own bucketed
        reductions (:meth:`_pipe_bucket_plan`) and GPipe's whole-tree one
        stays, with a warning."""
        if self.opts.dp_overlap != "1":
            return False
        if dplib.data_size(self.mesh) < 2:
            self._dp_warn_once("mesh has no data axis wider than 1")
            return False
        if self._pipelined:
            if self.pipe_schedule != "1f1b":
                self._dp_warn_once(
                    "the gpipe pipeline schedule's backward is autodiff-"
                    "scheduled (pipe_schedule = 1f1b composes)")
            return False
        extra_axes = [a for a in self.mesh.axes
                      if a not in ("data", "model")
                      and self.mesh.axis_size(a) > 1]
        if extra_axes:
            self._dp_warn_once(
                f"mesh axes {'/'.join(extra_axes)} need GSPMD-placed "
                "collectives (ring attention / expert all-to-all)")
            return False
        if dplib.model_size(self.mesh) > 1:
            from ..layers.moe import MoELayer
            if any(isinstance(c.layer, MoELayer)
                   for c in self.net.connections):
                self._dp_warn_once(
                    "the model axis hosts MoE experts; dispatch/combine "
                    "all-to-alls are GSPMD-placed")
                return False
        if self.remat or self.batch_split > 1:
            self._dp_warn_once("remat/batch_split paths schedule "
                               "their own backward")
            return False
        if self.buffers:
            self._dp_warn_once("stateful layers (running buffers, e.g. "
                               "batch_norm) don't thread through the "
                               "sliced vjp")
            return False
        if self.has_diagnostics:
            self._dp_warn_once("pairtest diagnostics need the implicit "
                               "forward")
            return False
        if self.opts.conv_sibling_fuse == "1" \
                or self.opts.concat_virtual == "1":
            self._dp_warn_once("conv_sibling_fuse/concat_virtual rewrite "
                               "the forward graph")
            return False
        if self._dp_overlap_plan() is None:
            self._dp_warn_once("a train-metric eval node sits before the "
                               "loss-tail frontier")
            return False
        return True

    def _overlap_backward(self, total: torch.Tensor, leaves, dp: str,
                          acc: Optional[Dict]) -> Dict:
        """The ``dp_overlap`` backward (:mod:`..parallel.overlap`): each
        bucket's reductions issued from the backward as its last
        gradient lands (``local``: none, the local gradients)."""
        from ..parallel import overlap
        reducer = None
        if dp != "local":
            plan = self._dp_overlap_plan()
            scatter = self.zero_leaves \
                if dp == "fold" or self.update_period == 1 else set()
            reducer = overlap.BucketReducer(
                leaves, overlap.plan_buckets_of_keys(plan), self.mesh,
                scatter=scatter,
                dtype=overlap.REDUCE_DTYPES[self.opts.dp_reduce_dtype])
        return overlap.run_backward(total, leaves, reducer=reducer, acc=acc)

    def check_weight_consistency(self) -> float:
        """Replica consistency, the ``test_on_server`` check: the largest
        |difference| of any parameter, optimizer-state or buffer leaf
        between the ranks that hold the same slice of it (ZeRO slices
        compare over the axes but ``data``, model and expert shards over
        the axes but theirs); NaN against
        a value is ``inf``.  0.0 when every replica agrees, and on one
        device.  Every rank of the mesh must call it."""
        if self.mesh is None or self.mesh.virtual:
            return 0.0

        def split(i: int, pkey: str, tag: str) -> Optional[str]:
            axis, _ = self._shard_of(pkey, tag)
            if axis is not None:
                return axis
            if i == 1 and (pkey, tag) in self.zero_leaves:
                return "data"
            return None
        return dplib.weight_consistency(
            [self.params, self.opt_state or {}, self.buffers], self.mesh,
            split)

    def _count_shape(self, seen: set, counter: str, inputs) -> None:
        """Count a batch shape the step has not seen (what retraces the
        JAX package's jitted step) into ``counter``."""
        key = tuple(tuple(v.shape) for v in inputs.values())
        if key not in seen:
            seen.add(key)
            self.metrics.counter_inc(counter)

    def _monitor_tick(self, loss: torch.Tensor, mon) -> None:
        """One monitored step on the host: a ``monitor`` record per
        parameter leaf (first: on a fatal NaN they are the diagnostics
        worth having), the reference-style monitor line, then the NaN /
        inf loss guard (``monitor_nan``: a ``nan`` record, and a warning
        or :class:`~..monitor.TrainingDiverged`).  The step's one
        deliberate host sync."""
        self.monitor_ticks += 1
        lval = float(loss)
        stats = ingraph.unpack_stats(ingraph.to_host(mon))
        for name, st in stats.items():
            self.metrics.emit("monitor", step=self.sample_counter,
                              round=self.round, layer=name, **st)
        if not mlog.is_silent():
            parts = " ".join(
                f"{name}[|w|={st['w_norm']:.4g},|dw|={st['g_norm']:.4g},"
                f"u/w={st['u_ratio']:.3g}]" for name, st in stats.items())
            mlog.info(f"monitor[{self.sample_counter}] loss={lval:.6g} "
                      f"{parts}")
        if not np.isfinite(lval) and self.monitor_nan != "off":
            msg = (f"monitor: non-finite loss {lval} at step "
                   f"{self.sample_counter} (round {self.round}); "
                   f"monitor_nan={self.monitor_nan}")
            self.metrics.counter_inc("nonfinite_loss_steps")
            self.metrics.emit("nan", step=self.sample_counter,
                              round=self.round, loss=lval,
                              action=self.monitor_nan)
            if self.monitor_nan == "fatal":
                raise TrainingDiverged(msg)
            mlog.warn(msg)

    def memory_gauges(self) -> Dict[str, int]:
        """``hbm_peak_bytes`` / ``hbm_bytes_in_use`` of the trainer's
        device from the caching allocator (empty on the CPU); the peak is
        the process's high-water, across the resets of
        :meth:`arm_mem_probe`."""
        g = device_memory_gauges(self.device)
        if g:
            g["hbm_peak_bytes"] = max(g["hbm_peak_bytes"], self._hbm_floor)
        return g

    def arm_mem_probe(self) -> AllocProbe:
        """Read the caching allocator through the next update step (the
        card only): returns the :class:`~..monitor.memory.AllocProbe`,
        which holds the step's readings once it ran.  Its start resets
        the allocator's peak, whose earlier high-water
        :meth:`memory_gauges` keeps."""
        dev = self.device

        def reset() -> None:
            self._hbm_floor = max(self._hbm_floor,
                                  torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)

        self.mem_probe = AllocProbe(
            lambda: torch.cuda.memory_allocated(dev),
            peak=lambda: torch.cuda.max_memory_allocated(dev), reset=reset)
        return self.mem_probe

    @property
    def has_diagnostics(self) -> bool:
        """True when a layer emits step diagnostics (pairtest)."""
        from ..layers.pairtest import PairTestLayer
        return any(isinstance(c.layer, PairTestLayer)
                   for c in self.net.connections)

    def diagnostics_host(self) -> Dict[str, float]:
        """:attr:`last_diags` as host floats, read in one transfer."""
        return diagnostics_to_host([self.last_diags])[0]

    def layer_scopes(self) -> List[str]:
        """Each connection's :func:`~..layers.base.conn_scope_name`, the
        range names layer attribution joins kernels against."""
        return list(self.net.scope_names)

    def label_info(self, label: torch.Tensor) -> LabelInfo:
        """The label fields of a (batch, label width) device tensor: the
        whole vector, or a rank's :meth:`_local_label` of it."""
        fields = self._label_fields
        if self.seq_split and label.shape[1] != self.netcfg.label_width():
            fields = self._local_fields()
        return LabelInfo(fields={name: label[:, a:b]
                                 for name, a, b in fields})

    def apply_update(self, grads: Dict, epoch: int) -> None:
        """The updater on every (layer, tag), in place; ``fused_update =
        1`` sends the tensors its gate admits through the fused adam
        kernel.  A ZeRO leaf is updated on this rank's row block (its
        gradient's block: the reduce-scattered one, or a block of a whole
        one) and the blocks are all-gathered back into the parameter."""
        fused = self.opts.fused_update == "1"
        gathers = []
        with record_function("train_update"):
            for pkey, group in self.params.items():
                for tag, p in group.items():
                    g = grads[pkey][tag]
                    view = self._opt_view(pkey, tag, p)
                    if view is not p and g.shape[0] == p.shape[0]:
                        g = dplib.axis_block(g, self.mesh, "data")
                    self.updater.apply(view, g, self.opt_state[pkey][tag],
                                       self.hypers[pkey][tag], epoch,
                                       fused=fused)
                    if view is not p:
                        gathers.append((p, view))
            for p, view in gathers:
                meshlib.all_gather(view.clone(), self.mesh, "data", out=p)

    def sync(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ forward
    def forward_eval(self, data: torch.Tensor, node_ids: Sequence[int],
                     extra_data: Sequence[torch.Tensor] = (),
                     host: bool = True) -> List:
        """Eval forward of a ``(n, c, y, x)`` batch (and its extra input
        nodes), tensors on the trainer's device as a staged batch holds
        them; float32 numpy values of the requested nodes (``host =
        False``: float32 tensors on the device)."""
        inputs = dict(enumerate([data, *extra_data]))
        inputs[0] = self.stage_input(self._normalize_input(inputs[0]))
        self._count_shape(self._eval_shapes, "eval_step_traces", inputs)
        outs = self.eval_nodes(inputs, node_ids)
        return [o.cpu().numpy() for o in outs] if host else outs

    def eval_nodes(self, inputs: Dict[int, torch.Tensor],
                   node_ids: Sequence[int], params=None
                   ) -> List[torch.Tensor]:
        """The eval forward of staged input nodes (this rank's rows and
        positions) with ``params`` (this rank's leaves, the trainer's
        own by default: a serve variant's cast or dequantized copy, cut
        as they are); the requested nodes' values as float32 device
        tensors.  A model-sharded leaf is gathered where it is read; on
        a pipelined mesh the nodes of the last stage come through the
        stages."""
        if self._pipelined and len(inputs) == 1 \
                and set(node_ids) <= self._pipe_tail_nodes():
            # through the stages, the nodes from the last one
            with torch.no_grad():
                _, got, _ = self._pipe_run(inputs, None, self.epoch_counter,
                                           train=False,
                                           node_ids=list(dict.fromkeys(
                                               node_ids)), params=params)
            return [got[n].float() for n in node_ids]
        with torch.inference_mode():
            nodes = self.net.forward(self._run_params(params), inputs,
                                     self.context(), buffers=self.buffers)
        return [materialize(nodes[n]).float() for n in node_ids]

    def _node_rows(self, batch, nid: int) -> np.ndarray:
        """Node ``nid`` of a batch's (host or staged) eval forward as
        (valid rows, values) float32, the padding rows dropped.  On a
        mesh every rank returns every row of the batch, in its order
        (:meth:`_batch_rows`)."""
        sb = self._staged(batch)
        [out] = self._batch_rows(
            self.forward_eval(sb.data, [nid], sb.extra_data, host=False))
        n = sb.batch_size - sb.num_batch_padd
        return out.reshape(out.shape[0], -1)[:n]

    def predict_raw(self, batch) -> np.ndarray:
        """The final node's values of each valid row (``task =
        pred_raw``)."""
        return self._node_rows(batch, self.net.final_node)

    def predict(self, batch) -> np.ndarray:
        """Each valid row's prediction: the argmax of the final node for
        more than one class, else its value (reference TransformPred)."""
        raw = self.predict_raw(batch)
        if raw.shape[1] > 1:
            return raw.argmax(axis=1).astype(np.float32)
        return raw[:, 0]

    def extract_feature(self, batch, node_name: str) -> np.ndarray:
        """Node ``node_name``'s values of each valid row (``task =
        extract``), with the read fixups applied."""
        nid = self.net.node_id(node_name)
        return self._apply_read_fixup(nid, self._node_rows(batch, nid))

    def _apply_read_fixup(self, nid: int, out: np.ndarray) -> np.ndarray:
        """Undo the relu -> pool reorder for a node read at call time: add
        back a deferred conv bias and apply a deferred relu (the JAX
        package's ``_apply_read_fixup``)."""
        fix = self._read_fixups.get(nid)
        if fix is None:
            return out
        kind, bias_key = fix
        flat = out.shape
        out = out.reshape((flat[0],) + tuple(self.net.node_shapes[nid][1:]))
        if bias_key is not None:
            bias = self.params[bias_key]["bias"].float().cpu().numpy()
            out = out + bias.reshape((-1,) + (1,) * (out.ndim - 2))
        if kind == "relu":
            out = np.maximum(out, np.float32(0))
        return out.reshape(flat)

    def _add_eval(self, metric: MetricSet, preds: List[np.ndarray],
                  label: np.ndarray, n_padd: int) -> None:
        """One batch's eval-node values (in ``eval_node_ids`` order) into
        ``metric``, the last ``n_padd`` (padding) instances excluded."""
        n = label.shape[0] - n_padd
        label = np.asarray(label)
        metric.add_eval([p[:n].reshape(n, -1) for p in preds],
                        {name: label[:n, a:b]
                         for name, a, b in self._label_fields})

    def evaluate(self, data_iter, name: str) -> str:
        """One pass of ``data_iter`` (host batches, or a
        :class:`~..io.device_prefetch.DevicePrefetcher`'s staged ones)
        through the eval forward into the metric, a batch a dispatch;
        returns its ``\tname-metric:value`` line fragment."""
        self.metric.clear()
        for batch in data_iter:
            sb = self._staged(batch)
            self._add_batch_eval(
                self.metric, self.forward_eval(sb.data, self.eval_node_ids,
                                               sb.extra_data, host=False),
                sb)
        return self.metric.print_line(name)

    def _add_batch_eval(self, metric: MetricSet,
                        preds: List[torch.Tensor], sb) -> None:
        """A staged batch's eval-node values into ``metric``, padding
        excluded.  On a data mesh the metric counts the global batch:
        every rank's rows and labels (:meth:`_batch_rows`)."""
        label = sb.label_host
        if self._data_split():
            label = torch.from_numpy(np.asarray(label, np.float32)) \
                .to(self.device)
        label, *preds = self._batch_rows(preds, label)
        self._add_eval(metric, preds, label, sb.num_batch_padd)

    def _batch_rows(self, preds: List[torch.Tensor],
                    label: Optional[torch.Tensor] = None
                    ) -> List[np.ndarray]:
        """Eval-node values of this rank's rows of a staged batch as
        float32 host arrays of the whole batch's rows, in its order (the
        padding rows, its last ``num_batch_padd``, kept): on a seq axis
        that splits the positions the blocks are joined over ``seq``,
        on a data mesh every rank's rows all-gathered over ``data`` (a
        pipelined mesh interleaves the ranks' rows microbatch by
        microbatch), so every rank holds them all.  ``label``, this
        rank's label rows, comes first in the result when given."""
        if self.seq_split:
            # every row's positions: the blocks joined over seq
            blk = self._position_block()
            preds = [meshlib.all_gather(
                p.movedim(2, 0).contiguous(), self.mesh, "seq").movedim(0, 2)
                if p.dim() >= 3 and p.shape[2] == blk.stop - blk.start
                else p for p in preds]
        ts = ([] if label is None else [label]) + list(preds)
        if not self._data_split():
            return [np.asarray(t) if isinstance(t, np.ndarray)
                    else t.cpu().numpy() for t in ts]
        n_local = ts[0].shape[0]
        nd = dplib.data_size(self.mesh)
        total = n_local * nd
        held = np.concatenate([np.arange(total)[self._rows(total, d)]
                               for d in range(nd)])
        every = [meshlib.all_gather(t.reshape(n_local, -1).contiguous(),
                                    self.mesh, "data") for t in ts]
        order = np.argsort(held, kind="stable")
        return [t.cpu().numpy()[order] for t in every]

    def start_round(self, r: int) -> None:
        self.round = r
        self.train_metric.clear()

    def context(self, decode=None) -> ForwardContext:
        return ForwardContext(train=False, opts=self.opts, decode=decode,
                              mesh=self.mesh, seq_split=self.seq_split)


def _replaying(fn, gen: Optional[torch.Generator]):
    """``fn`` for ``torch.utils.checkpoint`` whose second call (the
    recompute in the backward) draws what its first call drew from
    ``gen``: ``gen``'s state before the first call is set for the
    second, and its state then put back, so the stream goes on as if
    nothing ran again."""
    if gen is None:
        return fn
    before = []

    def run(*args):
        if not before:
            before.append(gen.get_state())
            return fn(*args)
        now = gen.get_state()
        gen.set_state(before[0])
        try:
            return fn(*args)
        finally:
            gen.set_state(now)
    return run

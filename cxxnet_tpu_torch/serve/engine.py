"""Pinned-shape predict engine (the JAX package's ``serve/engine.py``).

The engine declares its batch shapes up front (``serve_shapes =
1,8,32``), runs each bucket once at :meth:`PredictEngine.warmup` (the
kernels build and the libraries pick their algorithms there), and pads
every request up to the nearest bucket, so the device only ever sees
the declared shapes: a later CUDA-graph capture can take each.
:attr:`PredictEngine.retraces` counts dispatches at a shape warmup did
not run, which the bucketing makes 0 by construction; it stays so the
records match the JAX package's.

``serve_dtype`` selects the predict variant:

* ``f32`` — the reference: the trainer's own parameter tensors.
* ``bf16`` — a bfloat16 copy of the floating parameters; each dispatch
  casts its input to bfloat16 (the net then computes in its own dtype on
  the rounded values, as the JAX package's does).
* ``int8`` — per-output-channel symmetric int8 quantization of the
  ``wmat`` of every ``conv`` / ``fullc`` connection that owns its
  parameters (scale = absmax / 127 per channel on dim 0); the int8
  tensors and their scales stay on the device and each dispatch
  dequantizes them (``q * scale``) before the forward: weight-only
  quantization, in plain PyTorch as the reference's is plain XLA.

Each quantized variant is pairtested against the f32 reference within
the declared :data:`SERVE_TOL` envelope (:meth:`PredictEngine.pairtest`,
run by ``serve_calib`` at task startup).

On a mesh (one rank a device, ``parallel/mesh.py``) rank 0 hosts the
engine and every other rank runs :meth:`PredictEngine.follow`: each
forward of rank 0 (a bucket's warmup, a predict, the f32 reference) is
one collective dispatch.  Rank 0 broadcasts a header (op, bucket, valid
rows, variant) and the bucket's padded rows; every rank runs its rows of
them (its block of the ``data`` axis, the model axis's gathers as in the
trainer's eval forward) and the rows are all-gathered, so rank 0 holds
the bucket's output.  :meth:`PredictEngine.stop` ends the followers.
Every bucket must divide over the ``data`` axis.  A variant's cast and
quantization are made on each rank's own leaves: a model-axis shard
holds whole output channels (rows of dim 0), so its per-channel scales
are the logical weight's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..layers.conv import ConvolutionLayer
from ..layers.fullc import FullConnectLayer
from ..monitor import log as mlog
from ..monitor.metrics import copy_racy
from ..parallel import mesh as meshlib
from .decode import _tree_bytes

#: declared pairtest envelopes per predict variant (the JAX package's):
#: max |variant - f32| / (max |f32| + 1e-6) over one predict call
SERVE_TOL = {"f32": 0.0, "bf16": 2e-2, "int8": 6e-2}

#: a collective dispatch's header ops, and its variants: the serve
#: variant (``serve_dtype``) or the f32 reference (the trainer's params)
_STOP, _RUN = 0, 1
_SERVE, _REFERENCE = 0, 1


def quantize_per_channel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of a weight whose
    dim 0 is the output channel (fullc ``(nhidden, nin)``, conv
    ``(nchannel, cin/g, kh, kw)``).  Returns ``(q, scale)`` with ``q *
    scale ~= w``; a dead channel (all zeros) gets scale 0."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w).reshape(w.shape[0], -1), axis=1)
    scale = absmax / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(w / safe.reshape((-1,) + (1,) * (w.ndim - 1))),
                -127, 127).astype(np.int8)
    return q, scale.reshape((-1,) + (1,) * (w.ndim - 1)).astype(np.float32)


class PredictEngine:
    """Pinned-shape predict over a loaded trainer: build once,
    :meth:`warmup` once, then :meth:`predict` from one thread at a time
    (concurrent callers go through
    :class:`~cxxnet_tpu_torch.serve.batcher.MicroBatcher`, which also
    coalesces them into fuller buckets)."""

    def __init__(self, trainer, *, shapes: Sequence[int] = (1, 8, 32),
                 dtype: str = "f32", metrics=None):
        if trainer.net is None:
            raise ValueError("PredictEngine needs an initialized/loaded "
                             "trainer")
        self.trainer = trainer
        self.shapes = tuple(sorted(set(int(s) for s in shapes)))
        if not self.shapes or any(s <= 0 for s in self.shapes):
            raise ValueError(f"serve_shapes must be positive, got {shapes}")
        if dtype not in SERVE_TOL:
            raise ValueError(f"serve_dtype = {dtype!r}: expected one of "
                             f"{'/'.join(SERVE_TOL)}")
        self.dtype = dtype
        self.device = trainer.device
        mesh = trainer.mesh
        # a mesh with a process group: rank 0 dispatches, the others
        # follow (a virtual mesh has no group and no follower)
        self.mesh = mesh if mesh is not None and not mesh.virtual \
            and mesh.size > 1 else None
        ndata = mesh.axis_size("data") if mesh is not None else 1
        bad = [s for s in self.shapes if s % ndata]
        if bad:
            raise ValueError(
                f"serve_shapes {bad} not divisible by the mesh data "
                f"axis ({ndata}); every bucket shards over it")
        # one collective dispatch at a time: the header, the rows, the
        # forward and the gather of one never interleave with another's
        self._dispatch_lock = threading.Lock()
        # the span tracer's registry (the pad / device / unpad spans)
        self.metrics = metrics if metrics is not None else trainer.metrics
        self._params, self._scales = self._prepare_params()
        self._warm: Optional[set] = None
        self.retraces = 0
        self.warmup_sec = 0.0
        # dispatch accounting: which bucket each dispatch landed in and
        # how many pad rows it cost (dispatcher-thread writer only)
        self.bucket_hist: Dict[int, int] = {}
        self.pad_rows = 0
        self.dispatches = 0

    # ------------------------------------------------------------- params
    def _quant_keys(self) -> set:
        return {c.param_key for c in self.trainer.net.connections
                if c.owns_params
                and type(c.layer) in (ConvolutionLayer, FullConnectLayer)}

    def _prepare_params(self):
        """The serve-side parameters (and, for int8, the per-channel
        scales).  f32 aliases the trainer's tensors: a variant costs
        extra weight memory only where it transforms them."""
        t = self.trainer
        if self.dtype == "f32":
            return t.params, {}
        if self.dtype == "bf16":
            return {k: {tag: p.to(torch.bfloat16) if p.is_floating_point()
                        else p for tag, p in g.items()}
                    for k, g in t.params.items()}, {}
        qkeys = self._quant_keys()
        params, scales = {}, {}
        for pkey, group in t.params.items():
            if pkey in qkeys and "wmat" in group:
                q, s = quantize_per_channel(
                    group["wmat"].float().cpu().numpy())
                params[pkey] = dict(group, wmat=torch.from_numpy(q)
                                    .to(self.device))
                scales[pkey] = {"wmat": torch.from_numpy(s)
                                .to(self.device)}
            else:
                params[pkey] = group
        return params, scales

    def _dequant(self):
        """The weights one dispatch computes with: int8 ``q * scale`` in
        float32, the other variants as stored."""
        if not self._scales:
            return self._params
        out = dict(self._params)
        for pkey, sg in self._scales.items():
            out[pkey] = dict(out[pkey], wmat=out[pkey]["wmat"].float()
                             * sg["wmat"])
        return out

    @property
    def _in_shape(self) -> Tuple[int, ...]:
        return tuple(self.trainer.net.node_shapes[0][1:])

    def _wire_device(self) -> torch.device:
        """Where a dispatch's header and rows travel: the card for NCCL,
        the host for gloo (which stages CUDA tensors through it)."""
        return self.device if self.mesh.backend == "nccl" \
            else torch.device("cpu")

    def _dispatch(self, variant: int, rows: np.ndarray,
                  take: int) -> np.ndarray:
        """Final-node values of a bucket's padded ``rows`` as (b, values)
        float32 with ``variant``'s params; on a mesh one collective
        dispatch (rank 0 only: the followers run it in :meth:`follow`)."""
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError(
                f"PredictEngine: rank {self.mesh.rank} of a mesh dispatches "
                "nothing; rank 0 does and the other ranks follow it")
        x = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        with self._dispatch_lock:
            if self.mesh is not None:
                wire = self._wire_device()
                head = torch.tensor([_RUN, x.shape[0], take, variant],
                                    dtype=torch.int64, device=wire)
                meshlib.broadcast(head, self.mesh, None)
                x = meshlib.broadcast(x.to(wire), self.mesh, None)
            return self._run(variant, x)

    def follow(self) -> None:
        """A rank other than 0 of a mesh: run every dispatch rank 0
        broadcasts, until its :meth:`stop`."""
        wire = self._wire_device()
        while True:
            head = meshlib.broadcast(
                torch.zeros(4, dtype=torch.int64, device=wire), self.mesh,
                None)
            op, b, _, variant = (int(v) for v in head.tolist())
            if op == _STOP:
                return
            x = meshlib.broadcast(
                torch.empty((b,) + self._in_shape, dtype=torch.float32,
                            device=wire), self.mesh, None)
            self._run(variant, x)

    def stop(self) -> None:
        """Rank 0 of a mesh: end the followers' :meth:`follow` (a no-op
        elsewhere).  Called once, after the last dispatch: the serve
        task sends it from a ``finally`` once the batcher is closed, so
        that an error on rank 0 leaves no rank waiting."""
        mesh = self.mesh
        if mesh is None or mesh.rank != 0:
            return
        with self._dispatch_lock:
            meshlib.broadcast(torch.tensor(
                [_STOP, 0, 0, 0], dtype=torch.int64,
                device=self._wire_device()), mesh, None)

    def _run(self, variant: int, x: torch.Tensor) -> np.ndarray:
        """The eval forward of a bucket's rows ``x`` (host or wire
        tensor, all ``b`` of them): this rank's rows of them and, on a
        seq axis, its positions, through the trainer's eval forward with
        ``variant``'s params, read back to the host (the device sync)
        with every rank's rows as (b, values) float32."""
        t = self.trainer
        params = self._dequant() if variant == _SERVE else t.params
        if t._data_split():
            rows = t._rows(x.shape[0])
            x = x[torch.as_tensor(rows) if isinstance(rows, np.ndarray)
                  else rows]
        x = x[..., t._position_block()]
        x = x.to(self.device, non_blocking=True)
        if variant == _SERVE and self.dtype == "bf16":
            x = x.to(torch.bfloat16)
        [out] = t.eval_nodes({0: t.stage_input(x)}, [t.net.final_node],
                             params)
        [out] = t._batch_rows([out])
        return out.reshape(out.shape[0], -1)

    def _padded(self, x: np.ndarray, i: int, take: int, b: int):
        chunk = x[i:i + take]
        if take < b:
            chunk = np.concatenate(
                [chunk, np.zeros((b - take,) + self._in_shape, np.float32)])
        return chunk

    def warmup(self) -> None:
        """Run every declared bucket once (kernel builds, library
        algorithm choice) and wait for the device; from here on a
        dispatch at any other shape counts in :attr:`retraces`."""
        t0 = time.perf_counter()
        for b in self.shapes:
            self._dispatch(_SERVE, np.zeros((b,) + self._in_shape,
                                            np.float32), b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = set(self.shapes)
        self.warmup_sec = time.perf_counter() - t0

    @property
    def warmed(self) -> bool:
        return self._warm is not None

    def footprint(self) -> Dict[str, int]:
        """Resident device bytes this model costs: the serve-variant
        weights and scales counted once, the trainer's buffers, and for
        a cast or quantized variant the trainer's own copies of what it
        transformed (the trainer stays alive); ``opt_bytes`` is the
        optimizer state the trainer holds on the device.  Empty before
        warmup."""
        if self._warm is None:
            return {}
        t = self.trainer
        weight = _tree_bytes(self._params) + _tree_bytes(self._scales) \
            + _tree_bytes(t.buffers)
        if self.dtype == "bf16":
            weight += _tree_bytes(t.params)
        elif self.dtype == "int8":
            for pkey in self._scales:
                weight += _tree_bytes(t.params[pkey]["wmat"])
        opt = _tree_bytes(t.opt_state or {})
        return {"weight_bytes": weight, "opt_bytes": opt,
                "buckets": len(self._warm), "total_bytes": weight + opt}

    def stats(self) -> Dict[str, object]:
        """Dispatch accounting: bucket occupancy and padding waste."""
        return {"dispatches": self.dispatches,
                "bucket_hist": {str(k): v for k, v in sorted(
                    copy_racy(self.bucket_hist).items())},
                "pad_rows": self.pad_rows,
                "warmup_sec": round(self.warmup_sec, 3)}

    # ------------------------------------------------------------ predict
    def bucket_for(self, n: int) -> int:
        """Smallest declared bucket holding ``n`` rows (the largest for
        more)."""
        for b in self.shapes:
            if n <= b:
                return b
        return self.shapes[-1]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Final-node rows for ``x`` (``(n,) + input_shape``), any ``n``:
        an oversize request splits into largest-bucket dispatches, the
        remainder pads up to its nearest bucket."""
        if self._warm is None:
            self.warmup()
        x = np.asarray(x, np.float32)
        if x.shape[1:] != self._in_shape:
            raise ValueError(f"predict: rows of shape {x.shape[1:]} but the "
                             f"model takes {self._in_shape}")
        n = x.shape[0]
        # pad (the host pad) / device (on a mesh the broadcast, then the
        # copy to the device, the forward, the gather and the read-back)
        # / unpad spans inside the batcher's dispatch span,
        # the riders from the tracer's link: a dispatch with no sampled
        # rider emits none
        tracer = self.metrics.tracer if self.metrics is not None else None
        tracing = tracer is not None and tracer.enabled \
            and tracer.linked() is not None
        outs, i = [], 0
        while i < n:
            take = min(n - i, self.shapes[-1])
            b = self.bucket_for(take)
            if b not in self._warm:
                self._warm.add(b)
                self.retraces += 1
            self.bucket_hist[b] = self.bucket_hist.get(b, 0) + 1
            self.pad_rows += b - take
            self.dispatches += 1
            t_pad0 = time.perf_counter() if tracing else 0.0
            rows = self._padded(x, i, take, b)
            if tracing:
                t_dev0 = time.perf_counter()
                tracer.emit("pad", t_pad0, t_dev0, bucket=b, rows=take)
            out = self._dispatch(_SERVE, rows, take)
            if tracing:
                t_unpad0 = time.perf_counter()
                tracer.emit("device", t_dev0, t_unpad0, bucket=b, rows=take)
            outs.append(out[:take])
            if tracing:
                tracer.emit("unpad", t_unpad0, time.perf_counter(), bucket=b,
                            rows=take)
            i += take
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    # ----------------------------------------------------------- pairtest
    def reference_predict(self, x: np.ndarray) -> np.ndarray:
        """The f32 reference: the trainer's own parameters, the rows
        padded to the declared buckets as :meth:`predict` pads them
        (not counted as dispatches)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        outs, i = [], 0
        while i < n:
            take = min(n - i, self.shapes[-1])
            b = self.bucket_for(take)
            outs.append(self._dispatch(_REFERENCE,
                                       self._padded(x, i, take, b),
                                       take)[:take])
            i += take
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def pairtest(self, x: np.ndarray) -> float:
        """Max relative error of this variant against the f32 reference
        on ``x``: the measured side of the :data:`SERVE_TOL` envelope."""
        got = self.predict(x)
        ref = self.reference_predict(np.asarray(x, np.float32))
        denom = float(np.max(np.abs(ref))) + 1e-6
        err = float(np.max(np.abs(got - ref))) / denom
        tol = SERVE_TOL[self.dtype]
        if tol and err > tol:
            mlog.warn(f"serve pairtest: {self.dtype} predict deviates "
                      f"{err:.3g} from f32 (envelope {tol:g})")
        return err

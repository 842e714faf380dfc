"""Device selection, mesh specs and the data mesh over
``torch.distributed`` (the JAX package's ``parallel/mesh.py``).

``dev = cpu | gpu | gpu:0 | gpu:0-3 | gpu:1,3`` and ``mesh =
data:4,model:2`` parse here, for the trainer (``nnet/trainer.py``
``resolve_device``) and the config lint alike.

The building half: where the JAX package lays one SPMD program over a
``jax.sharding.Mesh``, the port runs one process a device (a *rank*),
joined in a ``torch.distributed`` process group.  :class:`Mesh` holds
the named axes, this rank's coordinate on each (row-major over the axes
in spec order, as ``np.array(devices).reshape(axes)`` lays the JAX
package's devices), the world group and one subgroup per axis: the
ranks that differ only on that axis.  The backend follows the device:
``nccl`` for ``cuda``, ``gloo`` for ``cpu`` (:func:`backend_for`);
:func:`build_mesh` takes another backend and an existing group, so two
ranks can share one card over gloo.  The collectives the data-parallel
plane calls (:func:`all_reduce`, :func:`reduce_scatter`,
:func:`all_gather`) live here, each over one axis of a mesh (or over
``(pipe, data)`` at once, a group of its own), as do the ring's and the
pipeline's point-to-point sends (:func:`ring_shift`, :func:`handoff`);
gloo has no reduce-scatter or all-gather of CUDA tensors, so a gloo mesh
on the card runs every collective through host copies.
:func:`recording` lists the collectives a block issues, on a virtual
mesh too: what the SPMD lint reads of a traced step.

Process bring-up: :func:`spawn` starts one rank a device with
``torch.multiprocessing`` (spawn), rendezvous on a ``FileStore`` in a
private temporary directory; a rank that dies fails the launch and the
others are terminated, never left waiting in a collective.
:func:`init_distributed` joins an external group (``CXN_COORDINATOR``
/ ``CXN_NUM_PROC`` / ``CXN_PROC_RANK``, the JAX package's multi-host
launch) over TCP.  A *virtual* mesh (:func:`virtual_mesh`) has the axes
and no group: the ``meta`` trainer of ``task = check`` models a rank of
it, and its collectives only give their outputs' shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def parse_device_spec(dev: str) -> Dict:
    """Parse ``dev = cpu | gpu | gpu:0 | gpu:0-3 | gpu:1,3`` (reference
    nnet_impl-inl.hpp:32-51 parses the gpu:0-3 form): ``{"platform",
    "ids"}``, ``ids`` None without a ``:`` suffix."""
    dev = dev.strip()
    if ":" not in dev:
        return {"platform": dev, "ids": None}
    platform, rng = dev.split(":", 1)
    ids: List[int] = []
    for part in rng.split(","):
        try:
            if "-" in part:
                a, b = part.split("-")
                ids.extend(range(int(a), int(b) + 1))
            else:
                ids.append(int(part))
        except ValueError:
            raise ValueError(f"dev suffix {rng!r}: expected i, i-j or "
                             "i,j") from None
    return {"platform": platform, "ids": ids}


#: mesh axis names with semantics: ``data`` shards the batch, ``model``
#: fullc / moe weights, ``seq`` ring attention, ``expert`` MoE dispatch,
#: ``pipe`` pipeline stages.  An unknown axis name would shard nothing,
#: so parse rejects it with a suggestion.
KNOWN_AXES = ("data", "model", "seq", "expert", "pipe")

#: the axes the port runs wider than 1: all of them
PORTED_AXES = ("data", "model", "seq", "expert", "pipe")

#: axes summed together in one reduction, with a group of their own on
#: a mesh where both are wider than 1: a pipelined step's gradients sum
#: over (pipe, data) at once (``parallel/pipeline.py``)
MERGED_AXES = (("pipe", "data"),)


@dataclasses.dataclass
class MeshSpec:
    """Named mesh axes, e.g. {"data": 4, "model": 2}."""

    axes: Dict[str, int]

    @classmethod
    def parse(cls, s: str) -> "MeshSpec":
        """Parse ``mesh = data:4,model:2``.  Raises ``ValueError`` on
        unknown or duplicate axis names and non-positive sizes."""
        axes: Dict[str, int] = {}
        for part in s.split(","):
            name, sep, size = part.partition(":")
            name = name.strip()
            if not sep:
                raise ValueError(
                    f"mesh axis {part.strip()!r}: expected name:size")
            if name not in KNOWN_AXES:
                from ..analysis.schema import did_you_mean
                sugg = did_you_mean(name, KNOWN_AXES)
                raise ValueError(
                    f"unknown mesh axis {name!r} (axes with semantics: "
                    f"{', '.join(KNOWN_AXES)})"
                    + (f"; did you mean {sugg!r}?" if sugg else ""))
            if name in axes:
                raise ValueError(f"duplicate mesh axis {name!r}")
            try:
                n = int(size)
            except ValueError:
                raise ValueError(
                    f"mesh axis {name}: size {size.strip()!r} is not an "
                    "integer") from None
            if n < 1:
                raise ValueError(f"mesh axis {name}: size must be >= 1, "
                                 f"got {n}")
            axes[name] = n
        return cls(axes)

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def axis_size(self, name: str) -> int:
        """Size of ``name`` (1 when the axis is absent)."""
        return self.axes.get(name, 1)


def backend_for(device: torch.device) -> str:
    """The process-group backend a device's ranks use: ``nccl`` for the
    card, ``gloo`` for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def select_devices(dev: str) -> List[torch.device]:
    """The devices ``dev`` names, one a rank: ``cpu:0-3`` is four CPU
    ranks, ``gpu:0-3`` cards 0-3.  A ``gpu`` range naming more cards
    than are visible is refused with both counts: it never runs on
    fewer devices than it names; with no card at all, in the words of
    one id's refusal (``nnet/trainer.py`` ``resolve_device``)."""
    spec = parse_device_spec(dev.lower())
    platform = spec["platform"]
    ids = spec["ids"] or [0]
    if platform == "cpu":
        return [torch.device("cpu") for _ in ids]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not have:
        raise RuntimeError(
            f"dev = {dev}: no CUDA device is available; set dev = cpu to "
            "run on the CPU")
    if max(ids) >= have or len(ids) > have:
        raise ValueError(
            f"dev = {dev}: names {len(ids)} CUDA device(s) (ids "
            f"{','.join(map(str, ids))}) but {have} are visible")
    return [torch.device("cuda", i) for i in ids]


class Mesh:
    """One rank's view of the device mesh: ``axes`` (name -> size, spec
    order), ``rank`` / ``coord`` (its index on each axis), ``device``,
    the ``world`` group and one group per axis (:meth:`group`).  A
    virtual mesh (``backend`` None) has no groups."""

    def __init__(self, axes: Dict[str, int], rank: int,
                 device: torch.device, backend: Optional[str],
                 world: Any = None, groups: Optional[Dict[str, Any]] = None,
                 axis_ranks: Optional[Dict[str, List[int]]] = None) -> None:
        self.axes = dict(axes)
        self.rank = rank
        self.device = device
        self.backend = backend
        self.world = world
        self._groups = dict(groups or {})
        # axis -> the group's ranks (in the world group), in axis order
        self._axis_ranks = dict(axis_ranks or {})
        self.coord: Dict[str, int] = {}
        rest = rank
        for name in reversed(list(self.axes)):
            self.coord[name] = rest % self.axes[name]
            rest //= self.axes[name]
        self.coord = {a: self.coord[a] for a in self.axes}

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    @property
    def virtual(self) -> bool:
        return self.backend is None

    def axis_size(self, name) -> int:
        """Size of axis ``name`` (1 when absent); of a tuple of axes, the
        product."""
        if isinstance(name, tuple):
            n = 1
            for a in name:
                n *= self.axes.get(a, 1)
            return n
        return self.axes.get(name, 1)

    def axis_index(self, name: str) -> int:
        return self.coord.get(name, 0)

    def group(self, name) -> Any:
        """The process group of the ranks that differ from this one on
        axis ``name`` only; for a tuple of axes (one of MERGED_AXES), on
        those axes only."""
        if isinstance(name, tuple):
            wide = tuple(a for a in name if self.axis_size(a) > 1)
            if len(wide) <= 1:
                return self._groups.get(wide[0]) if wide else None
            return self._groups.get(wide)
        return self._groups.get(name)

    def axis_peer(self, name: str, step: int) -> int:
        """The world rank ``step`` places along axis ``name`` from this
        one (around the axis's ring)."""
        ranks = self._axis_ranks[name]
        return ranks[(self.axis_index(name) + step) % len(ranks)]

    def host_staged(self, t: torch.Tensor) -> bool:
        """gloo has no reduce-scatter / all-gather of CUDA tensors: a
        gloo mesh on the card stages its collectives through the host."""
        return self.backend == "gloo" and t.device.type == "cuda"


def _axis_groups(axes: Dict[str, int], rank: int, world_group: Any,
                 world_size: int):
    """One group per axis wider than 1 and one per MERGED_AXES pair of
    such axes, and its ranks in axis order.  Every rank creates every
    group in the same order (``new_group`` is collective) and keeps the
    one it is in; an axis spanning the world is the world group."""
    import torch.distributed as dist
    import numpy as np
    names = list(axes)
    grid = np.arange(world_size).reshape([axes[a] for a in names])
    groups: Dict[str, Any] = {}
    members: Dict[str, List[int]] = {}
    combos = [(name,) for name in names if axes[name] > 1]
    combos += [c for c in MERGED_AXES
               if all(a in axes and axes[a] > 1 for a in c)]
    for combo in combos:
        ks = [names.index(a) for a in combo]
        n = int(np.prod([axes[a] for a in combo]))
        moved = np.moveaxis(grid, ks, list(range(-len(ks), 0)))
        key = combo[0] if len(combo) == 1 else combo
        for ranks in moved.reshape(-1, n):
            ranks = [int(r) for r in ranks]
            g = world_group if n == world_size else dist.new_group(ranks)
            if rank in ranks:
                groups[key], members[key] = g, ranks
    return groups, members


def build_mesh(spec: Optional[MeshSpec], device: torch.device, *,
               backend: Optional[str] = None, group: Any = None) -> Mesh:
    """This rank's :class:`Mesh` over an initialized process group
    (``group``, else the default group).  ``spec`` None: one ``data``
    axis over the world.  ``backend`` defaults to the group's own."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh: no process group; start the ranks with "
            "parallel.mesh.spawn (the CLI does for dev = cpu:0-3 / "
            "gpu:0-3) or join one with init_distributed")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    spec = spec or MeshSpec({"data": world})
    if spec.size != world:
        raise ValueError(f"mesh axes {spec.axes} need {spec.size} ranks, "
                         f"the process group has {world}")
    backend = backend or str(dist.get_backend(group))
    world_group = group if group is not None else dist.group.WORLD
    groups, members = _axis_groups(spec.axes, rank, world_group, world)
    return Mesh(spec.axes, rank, device, backend, world_group, groups,
                members)


def virtual_mesh(spec: MeshSpec, device: torch.device) -> Mesh:
    """Rank 0 of a mesh of ``spec`` with no process group: what the
    ``meta`` trainer of ``task = check`` models."""
    return Mesh(spec.axes, 0, device, None)


#: seconds a collective may wait for the other ranks (torch's default)
COLLECTIVE_TIMEOUT_SEC = 1800.0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str = "gloo",
                     timeout_sec: float = COLLECTIVE_TIMEOUT_SEC) -> None:
    """Join an external process group over TCP at ``coordinator``
    (``host:port`` of process 0): the JAX package's multi-host bring-up
    (``CXN_COORDINATOR`` / ``CXN_NUM_PROC`` / ``CXN_PROC_RANK``)."""
    import torch.distributed as dist
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=addr, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_sec))


def _rank_entry(rank: int, fn: Callable, world: int, store_path: str,
                backend: str, timeout_sec: float, args: tuple) -> None:
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_sec))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          backend: str = "gloo", timeout_sec: Optional[float] = None
          ) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned ranks joined in one
    ``backend`` process group (a ``FileStore`` in a private temporary
    directory).  Returns when every rank returned; raises when one
    raised or died (the others are terminated at once, not left in a
    collective) and when the ranks outlive ``timeout_sec`` (None: no
    deadline; a collective then waits COLLECTIVE_TIMEOUT_SEC, else
    ``timeout_sec``)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="cxn_ranks_")
    ctx = mp.start_processes(
        _rank_entry, args=(fn, nprocs, os.path.join(tmp, "store"), backend,
                           timeout_sec or COLLECTIVE_TIMEOUT_SEC,
                           tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_sec is None \
        else time.monotonic() + timeout_sec
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"spawn: {nprocs} ranks still running after "
                    f"{timeout_sec:.0f} sec")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5.0)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ collectives
#: launches of each collective (by name), on every mesh of the process;
#: ``handoff`` counts the pipeline's stage handoffs (:func:`handoff`)
counts: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                          "all_gather": 0, "ring_shift": 0, "broadcast": 0,
                          "handoff": 0}

#: the open collective record (:func:`recording`), or None
_record: Optional[List[Tuple[str, Tuple[str, ...], str, int]]] = None


@contextlib.contextmanager
def recording():
    """Record every collective and stage handoff issued in the block, on
    any mesh (a virtual one too, where they only give their outputs'
    shapes): a list of ``(op, axes, dtype, numel)`` in call order, the
    wire's dtype for a reduction.  A call over an axis of size 1 (or
    one the mesh lacks) issues nothing and is not recorded.  The SPMD
    lint reads it (``analysis/spmdlint.py``)."""
    global _record
    saved, _record = _record, []
    try:
        yield _record
    finally:
        _record = saved


def _note(op: str, mesh: "Mesh", axis, t: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> None:
    if _record is None:
        return
    axes = axis if isinstance(axis, tuple) else (axis,)
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
    if axes:
        _record.append((op, axes, str(dtype or t.dtype).replace(
            "torch.", ""), int(t.numel())))


class Pending:
    """An issued collective: :meth:`wait` blocks until it finished and
    returns its result tensor."""

    def __init__(self, work, result: torch.Tensor,
                 finish: Optional[Callable[[], torch.Tensor]] = None):
        self._work = work
        self._result = result
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            self._result, self._finish = self._finish(), None
        return self._result


def _op(name: str):
    import torch.distributed as dist
    new = {"all_gather": "all_gather_single",
           "reduce_scatter": "reduce_scatter_single"}[name]
    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[name]
    return getattr(dist, new, None) or getattr(dist, old)


def _wire(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None or t.dtype == dtype else t.to(dtype)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "data", *,
               dtype: Optional[torch.dtype] = None,
               async_op: bool = False):
    """Sum ``t`` over ``axis``, in ``t``'s dtype (``dtype`` is the
    wire's, the JAX package's ``dp_reduce_dtype``).  Returns the sum
    (``t`` itself, reduced in place, when it is contiguous and needs no
    cast or host copy), or a :class:`Pending` of it under
    ``async_op``."""
    import torch.distributed as dist
    _note("all_reduce", mesh, axis, t, dtype)
    group = mesh.group(axis)
    if group is None:
        return Pending(None, t) if async_op else t
    counts["all_reduce"] += 1
    x = _wire(t, dtype).contiguous()
    if mesh.host_staged(x):
        x = x.cpu()
    work = dist.all_reduce(x, group=group, async_op=async_op)

    def finish() -> torch.Tensor:
        return x.to(t.device, t.dtype)
    if async_op:
        return Pending(work, t, finish)
    return finish()


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axis: str = "data", *,
                   dtype: Optional[torch.dtype] = None,
                   async_op: bool = False):
    """Sum ``t`` over ``axis`` and keep this rank's slice of the leading
    dim (its index on ``axis``); ``t.shape[0]`` must divide by the axis
    size.  Returns the slice, or a :class:`Pending` of it."""
    n = mesh.axis_size(axis)
    rows = t.shape[0] // n
    _note("reduce_scatter", mesh, axis, t, dtype)
    group = mesh.group(axis)
    if group is None:
        i = mesh.axis_index(axis)
        out = t.narrow(0, i * rows, rows).clone()
        return Pending(None, out) if async_op else out
    counts["reduce_scatter"] += 1
    x = _wire(t, dtype).contiguous()
    if mesh.host_staged(x):
        x = x.cpu()
    out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = _op("reduce_scatter")(out, x, group=group, async_op=async_op)

    def finish() -> torch.Tensor:
        return out.to(t.device, t.dtype)
    if async_op:
        return Pending(work, out, finish)
    return finish()


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str = "data",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``axis`` ranks' ``t`` joined on the leading dim, in their
    axis order (into ``out`` when given; ``out`` must not hold ``t``)."""
    n = mesh.axis_size(axis)
    shape = (t.shape[0] * n,) + tuple(t.shape[1:])
    _note("all_gather", mesh, axis, t)
    group = mesh.group(axis)
    if out is None:
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
    if group is None:
        if n == 1:
            out.copy_(t)
        else:
            # a virtual mesh: the output's shape, the local rows repeated
            out.copy_(t.repeat((n,) + (1,) * (t.dim() - 1)))
        return out
    counts["all_gather"] += 1
    x = t.contiguous()
    if mesh.host_staged(x):
        host = torch.empty(shape, dtype=t.dtype)
        _op("all_gather")(host, x.cpu(), group=group)
        out.copy_(host)
        return out
    _op("all_gather")(out, x, group=group)
    return out


def broadcast(t: torch.Tensor, mesh: Mesh, axis: Optional[str],
              src: int = 0) -> torch.Tensor:
    """The ``t`` of the rank at index ``src`` of ``axis``, on every rank
    of it (in place where no host copy is needed); ``axis`` None: of
    world rank ``src``, on every rank of the mesh."""
    import torch.distributed as dist
    _note("broadcast", mesh, tuple(mesh.axes) if axis is None else axis, t)
    if axis is None:
        group = mesh.world if mesh.size > 1 else None
    else:
        group = mesh.group(axis)
    if group is None:
        return t
    counts["broadcast"] += 1
    x = t.contiguous()
    staged = mesh.host_staged(x)
    if staged:
        x = x.cpu()
    root = src if axis is None else mesh._axis_ranks[axis][src]
    dist.broadcast(x, src=root, group=group)
    return x.to(t.device) if staged or x is not t else t


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str,
               step: int = 1) -> torch.Tensor:
    """``t`` sent ``step`` places along ``axis``'s ring, and the tensor of
    the rank ``step`` places before received (``lax.ppermute`` with the
    permutation ``i -> i + step``): a pair of point-to-point ops, through
    host copies where gloo carries CUDA tensors.  Without a group (one
    rank on the axis, a virtual mesh) a copy of ``t``."""
    import torch.distributed as dist
    n = mesh.axis_size(axis)
    if step % n:
        _note("ring_shift", mesh, axis, t)
    group = mesh.group(axis)
    if group is None or n == 1 or step % n == 0:
        return t.clone()
    counts["ring_shift"] += 1
    x = t.contiguous()
    staged = mesh.host_staged(x)
    if staged:
        x = x.cpu()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, mesh.axis_peer(axis, step), group),
        dist.P2POp(dist.irecv, out, mesh.axis_peer(axis, -step), group)])
    for r in reqs:
        r.wait()
    return out.to(t.device) if staged else out


#: one boundary value on the wire: (shape, dtype) of each of its tensors
Spec = List[Tuple[Tuple[int, ...], torch.dtype]]


def handoff(mesh: Mesh, axis: str,
            sends: Sequence[Tuple[int, Sequence[torch.Tensor]]],
            recvs: Sequence[Tuple[int, Spec]]) -> List[List[torch.Tensor]]:
    """One tick of stage handoffs along ``axis`` (the pipeline's
    ``lax.ppermute``): each ``(peer, tensors)`` of ``sends`` goes to the
    rank ``peer`` places along the axis (+1 the next stage, -1 the one
    before), and each ``(peer, spec)`` of ``recvs`` is a value of that
    shape arriving from the rank ``peer`` places along it.  Every op of
    the tick is posted in one ``batch_isend_irecv``, sends first, each
    tensor tagged by its place in its value and its direction of
    travel, so the ranks' posts pair up whatever their order.  gloo
    carries a CUDA tensor through a host copy.  Returns the received
    values, in ``recvs`` order.  On a virtual mesh (no group) the
    received values are zeros of their specs, and each sent value
    counts once in ``counts["handoff"]`` on a group."""
    import torch.distributed as dist
    for _, ts in sends:
        for t in ts:
            _note("handoff", mesh, axis, t)
    group = mesh.group(axis)
    if group is None:
        return [[torch.zeros(shape, dtype=dt, device=mesh.device)
                 for shape, dt in spec] for _, spec in recvs]
    counts["handoff"] += len(sends)
    staged = mesh.backend == "gloo" and mesh.device.type == "cuda"
    ops, outs = [], []
    for peer, ts in sends:
        base = 0 if peer > 0 else 1 << 10
        for i, t in enumerate(ts):
            x = t.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, x.cpu() if staged else x,
                                  mesh.axis_peer(axis, peer), group,
                                  tag=base + i))
    for peer, spec in recvs:
        base = 1 << 10 if peer > 0 else 0
        bufs = [torch.empty(shape, dtype=dt,
                            device="cpu" if staged else mesh.device)
                for shape, dt in spec]
        outs.append(bufs)
        for i, b in enumerate(bufs):
            ops.append(dist.P2POp(dist.irecv, b, mesh.axis_peer(axis, peer),
                                  group, tag=base + i))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    if staged:
        outs = [[b.to(mesh.device) for b in bufs] for bufs in outs]
    return outs


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh`` (a no-op without a group)."""
    if mesh is None or mesh.world is None:
        return
    import torch.distributed as dist
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.world, device_ids=[mesh.device.index or 0])
    else:
        dist.barrier(group=mesh.world)

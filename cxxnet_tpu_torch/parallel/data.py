"""The data-parallel plane's state and reductions over a :class:`Mesh`
(the JAX package's ``_make_shardings`` / implicit GSPMD step /
``check_weight_consistency``, written out).

A step on ``mesh = data:N`` computes the step of the global batch: each
rank runs forward and backward on its rows ``[d·B/N, (d+1)·B/N)`` (``d``
its ``data`` index) with the loss scaled by the global ``1 / (batch_size
· update_period)``, and the gradients are summed over ``data`` before the
update, so every replica ends the step with the same weights.

Placement at rest, per rank (:func:`plan_shards`, the JAX package's
rules):

* ``fullc_gather = 1`` on a ``model`` axis wider than 1: a 2-D
  ``wmat`` (a ``fullc``'s, an embedding's: the JAX package applies
  ``FullConnectLayer.model_shard_spec`` to every group) whose rows
  divide by the axis is held as its row shard; the
  forward all-gathers it (:class:`GatherModel`), compute is replicated
  over ``model``, and the backward keeps the shard's slice of the
  gradient;
* ``shard_opt_state = 1`` (``update_on_server = 1``) on a ``data`` axis
  wider than 1 (ZeRO): a replicated leaf with ``ndim >= 1``, ``shape[0]
  % N == 0`` and ``size >= 2**14`` keeps the optimizer state of its row
  slice only; its gradient is reduce-scattered, the rank updates its
  slice and the slices are all-gathered back into the parameter;
* a moe layer's per-expert leaves on the axis hosting the experts
  (``expert``, else ``model``): each rank holds its block of experts
  and their optimizer state (``layers/moe.py``).

On a ``seq`` axis that splits the positions, every rank holds its rows
and its block of positions: gradients and the loss sum over ``data``
and ``seq`` (:func:`token_axes`).

Snapshots hold the logical arrays (:func:`gather_leaf` joins a leaf's
shards); :func:`rank_slice` cuts a logical array back to what a rank
holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import mesh as meshlib

#: the ZeRO size floor (elements), the JAX package's
ZERO_MIN_SIZE = 2 ** 14


def data_size(mesh: Optional[meshlib.Mesh]) -> int:
    return mesh.axis_size("data") if mesh is not None else 1


def model_size(mesh: Optional[meshlib.Mesh]) -> int:
    return mesh.axis_size("model") if mesh is not None else 1


def row_slice(mesh: Optional[meshlib.Mesh], n: int,
              d: Optional[int] = None) -> slice:
    """The rows of an ``n``-row batch data rank ``d`` (this rank's by
    default) takes: its ``data`` index's block of ``n / N``."""
    nd = data_size(mesh)
    if n % nd:
        raise ValueError(f"batch of {n} rows does not divide over the "
                         f"data axis of {nd}")
    rows = n // nd
    if d is None:
        d = mesh.axis_index("data") if mesh is not None else 0
    return slice(d * rows, (d + 1) * rows)


def micro_rows(mesh: Optional[meshlib.Mesh], n: int, n_micro: int,
               d: Optional[int] = None) -> np.ndarray:
    """The rows of an ``n``-row batch data rank ``d`` takes on a
    pipelined mesh: the batch is cut into ``n_micro`` contiguous
    microbatches and each is sharded over ``data`` (the JAX package's
    ``_pipe_microbatches`` with its data spec), so the rank holds its
    block of every microbatch, microbatch after microbatch."""
    nd = data_size(mesh)
    if n % n_micro or (n // n_micro) % nd:
        raise ValueError(f"pipeline: batch {n} not divisible by "
                         f"pipe_microbatch {n_micro} microbatches of a "
                         f"multiple of the data axis of {nd}")
    mb = n // n_micro
    blk = row_slice(mesh, mb, d)
    return np.concatenate([np.arange(m * mb + blk.start, m * mb + blk.stop)
                           for m in range(n_micro)])


def plan_shards(params: Dict[str, Dict[str, torch.Tensor]], mesh,
                *, fullc_gather: bool, shard_opt_state: bool,
                expert_keys=frozenset()
                ) -> Tuple[Dict[Tuple[str, str], Tuple[int, ...]], set,
                           Dict[Tuple[str, str], Tuple[str, int]]]:
    """``(model-sharded leaves -> logical shape, ZeRO leaves,
    expert-sharded leaves -> (axis, logical rows))`` of the logical
    ``params``: the JAX package's ``_make_shardings`` rules (a pairtest
    side's ``master/wmat`` is a ``wmat``).  A moe layer's group (its key
    in ``expert_keys``) holds its per-expert leaves as their block of
    experts over the axis hosting them (``expert``, else ``model``),
    their optimizer state with them, and is never model- or
    ZeRO-sharded."""
    from ..layers.moe import expert_host_axis, expert_shard_rows
    msharded: Dict[Tuple[str, str], Tuple[int, ...]] = {}
    esharded: Dict[Tuple[str, str], Tuple[str, int]] = {}
    zero: set = set()
    nm, nd = model_size(mesh), data_size(mesh)
    eaxis = expert_host_axis(mesh)
    for pkey, group in params.items():
        for tag, p in group.items():
            if pkey in expert_keys:
                if eaxis is not None and expert_shard_rows(
                        tag, p.shape, mesh.axis_size(eaxis)):
                    esharded[(pkey, tag)] = (eaxis, int(p.shape[0]))
                    continue
            elif (fullc_gather and nm > 1
                    and tag.rsplit("/", 1)[-1] == "wmat"
                    and p.dim() == 2 and p.shape[0] % nm == 0):
                msharded[(pkey, tag)] = tuple(p.shape)
                continue
            if (shard_opt_state and nd > 1 and p.dim() >= 1
                    and p.shape[0] % nd == 0 and p.numel() >= ZERO_MIN_SIZE):
                zero.add((pkey, tag))
    return msharded, zero, esharded


def token_axes(seq_split: bool) -> Tuple[str, ...]:
    """The axes a step's tokens are split over, which every gradient and
    the loss sum over: ``data``, and ``seq`` when it splits the
    positions (``model`` and ``expert`` ranks hold the same tokens)."""
    return ("data", "seq") if seq_split else ("data",)


def axis_block(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``t``'s leading dim over ``axis`` (a view)."""
    n = mesh.axis_size(axis)
    rows = t.shape[0] // n
    return t.narrow(0, mesh.axis_index(axis) * rows, rows)


def rank_slice(t: torch.Tensor, mesh, sharded_over: Optional[str],
               full_rows: int) -> torch.Tensor:
    """A logical (full) leaf as this rank holds it when it is sharded
    over ``sharded_over``; a leaf already cut to the shard passes."""
    if sharded_over is None or t.dim() == 0 or t.shape[0] != full_rows:
        return t
    return axis_block(t, mesh, sharded_over).clone()


def gather_leaf(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A leaf sharded on its leading dim over ``axis`` -> the logical
    tensor (every rank of the axis gets it)."""
    return meshlib.all_gather(t.detach().contiguous(), mesh, axis)


class GatherModel(torch.autograd.Function):
    """Model-sharded leaf -> the full weight.  Forward: the ``model``
    all-gather.  Backward: the shard's SLICE of the cotangent, not the
    gather's transpose (a reduce-scatter): the computation reading the
    gathered weight is replicated over ``model``, so every replica's
    cotangent is already the whole gradient and summing them would scale
    it by the axis size (the JAX package's ``_gather_model_leaf``)."""

    @staticmethod
    def forward(ctx, shard, mesh):
        ctx.mesh = mesh
        return meshlib.all_gather(shard.contiguous(), mesh, "model")

    @staticmethod
    def backward(ctx, grad):
        return axis_block(grad, ctx.mesh, "model").contiguous(), None


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over a mesh axis, differentiable: the backward
    sums the cotangents over the same axis (every rank's output is the
    same sum, so each input's gradient is the sum of all the outputs'
    gradients)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return meshlib.all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return meshlib.all_reduce(grad.clone(), ctx.mesh, ctx.axis), \
            None, None


class SumPartials(torch.autograd.Function):
    """The sum over a mesh axis of partial results whose consumer is
    replicated over it (the moe layer's local experts' outputs): the
    forward all-reduces, the backward passes the cotangent through, as
    every rank's cotangent is already the whole one (summing them would
    scale the gradient by the axis size)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return meshlib.all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class SumGrads(torch.autograd.Function):
    """A replicated tensor entering computation that each rank of a mesh
    axis does a part of (the moe layer's local experts): the forward
    passes it through, the backward sums the parts' cotangents over the
    axis, so the gradient upstream is whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return meshlib.all_reduce(grad.clone(), ctx.mesh, ctx.axis), \
            None, None


def global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (a per-rank partial sum) summed over the ``data`` axis,
    under autograd: what batch-coupled layers (``batch_norm``'s
    statistics) reduce so the sharded batch behaves as the global one."""
    if data_size(mesh) <= 1:
        return x
    return AllReduceSum.apply(x, mesh, "data")


class GatheringParams(dict):
    """A params dict whose model-sharded leaves are all-gathered when a
    connection first reads its group (each at its own point of the
    forward), through :class:`GatherModel` under autograd."""

    def __init__(self, params, msharded, mesh):
        super().__init__(params)
        self._todo = {pkey for pkey, _ in msharded}
        self._msharded = msharded
        self._mesh = mesh

    def _materialize(self, key):
        group = dict.__getitem__(self, key)
        if key in self._todo:
            self._todo.discard(key)
            group = {t: GatherModel.apply(v, self._mesh)
                     if (key, t) in self._msharded else v
                     for t, v in group.items()}
            dict.__setitem__(self, key, group)
        return group

    def __getitem__(self, key):
        return self._materialize(key)

    def get(self, key, default=None):
        return self._materialize(key) if key in self else default


def reduce_grads(grads, mesh, zero: set, *, scatter: bool,
                 axes: Tuple[str, ...] = ("data",)):
    """The implicit step's reduction: every gradient summed over ``axes``
    (the token axes, :func:`token_axes`) leaf by leaf in ``grads``'
    order; ZeRO leaves reduce-scattered to their row slice over ``data``
    when ``scatter``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for pkey, group in grads.items():
        out[pkey] = {}
        for tag, g in group.items():
            for ax in axes[1:]:
                g = meshlib.all_reduce(g, mesh, ax)
            if scatter and (pkey, tag) in zero:
                out[pkey][tag] = meshlib.reduce_scatter(g, mesh, "data")
            else:
                out[pkey][tag] = meshlib.all_reduce(g, mesh, "data")
    return out


def replica_axes(mesh) -> Tuple[str, ...]:
    """The axes whose ranks hold the same tokens and compute the same
    replicated values (``model``, ``expert``), on a mesh with groups."""
    if mesh is None or mesh.virtual:
        return ()
    return tuple(a for a in ("model", "expert") if mesh.axis_size(a) > 1)


def sync_replicas(grads, mesh, shard_axis) -> None:
    """Make each reduced gradient bitwise one across the axes whose ranks
    compute it alike (:func:`replica_axes`): the value of the axis's
    first rank is broadcast (in place in ``grads``).  The ranks compute
    the same function, but a multi-threaded or atomic kernel may round
    differently from one process to the next, and replicas must not
    drift.  ``shard_axis(pkey, tag)`` names the axis a leaf is sharded
    over (its ranks hold different slices), or None."""
    axes = replica_axes(mesh)
    if not axes:
        return
    for pkey, group in grads.items():
        for tag, g in group.items():
            for ax in axes:
                if shard_axis(pkey, tag) != ax:
                    g = meshlib.broadcast(g, mesh, ax)
            group[tag] = g


def _leaf_drift(t: torch.Tensor, mesh, axis: str) -> float:
    """Largest |difference| of ``t`` between this rank and the other
    ranks of ``axis`` (inf for NaN against a value)."""
    if mesh.axis_size(axis) <= 1:
        return 0.0
    x = t.detach().float().reshape(1, -1).contiguous()
    every = meshlib.all_gather(x, mesh, axis)
    d = (every - x).abs()
    if bool(torch.isnan(d).any()):
        return float("inf")
    return float(d.max()) if d.numel() else 0.0


def weight_consistency(trees, mesh, sharded_over) -> float:
    """The ``test_on_server`` check: the largest |difference| of any
    leaf of ``trees`` (nested ``{group: {tag: tensor | {name: tensor}}}``
    trees) between ranks that hold the same slice of it.
    ``sharded_over(tree_index, pkey, tag)`` names the axis a leaf is
    split over (its holders of one slice differ on the other axes), or
    None for a replicated leaf.  0.0 means every replica agrees; the
    value is the same on every rank."""
    worst = 0.0
    axes = [a for a in mesh.axes if mesh.axis_size(a) > 1]
    for i, tree in enumerate(trees):
        for pkey, group in tree.items():
            for tag, leaf in group.items():
                leaves = leaf.values() if isinstance(leaf, dict) else [leaf]
                split = sharded_over(i, pkey, tag)
                for t in leaves:
                    for axis in axes:
                        if axis != split:
                            worst = max(worst, _leaf_drift(t, mesh, axis))
    # every rank returns the worst of all ranks
    every = torch.tensor([worst], dtype=torch.float32, device=mesh.device)
    for axis in axes:
        every = meshlib.all_gather(every.max().reshape(1), mesh, axis)
    return float(every.max())

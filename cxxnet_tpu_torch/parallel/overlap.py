"""Bucketed backward-overlapped gradient reduction for data parallelism
(``dp_overlap = 1``; the JAX package's ``parallel/overlap.py``).

Reference: the ``async_updater`` issues a layer's gradient push the
moment that layer's backward finishes, with priority ``-layer_index``,
so the transfers hide behind the rest of backprop.  Here, as in the JAX
package, the net's connections are partitioned into contiguous segments
whose owned-parameter footprint targets ``dp_bucket_mb`` MiB, walking
REVERSE layer order (the last layer's gradients are ready first):
:func:`plan_buckets` makes the JAX package's plan, bucket for bucket and
key for key.

Where the JAX package slices the forward into one ``vjp`` a segment to
place each bucket's ``psum`` at its grad-ready point, the port has that
point from autograd: :class:`BucketReducer` hangs a
``register_post_accumulate_grad_hook`` on every parameter leaf, and the
moment a bucket's last leaf has its gradient, the bucket's reductions
are issued as ``async_op`` collectives (an all-reduce over ``data``, or
a reduce-scatter for ZeRO leaves); the backward goes on behind them and
every handle is waited on before the update.

* ``dp_reduce_dtype = bf16`` casts gradients to bf16 for the wire and
  back (half the bytes);
* with ``update_period > 1`` and ``dp_reduce_at = apply`` (the default)
  micro-steps accumulate LOCAL gradients and the apply step folds them
  into its backward's ``.grad`` and reduces each bucket once (the
  cross-rank sum reassociates, so the trajectory matches the implicit
  step to rounding, not bitwise); ``dp_reduce_at = step`` reduces every
  micro-step.

At f32 and ``dp_reduce_at = step`` each gradient is the same local
backward's, summed over the same ranks as the implicit step's, so on two
ranks (where a sum does not depend on its order) the trajectories are
bitwise equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import mesh as meshlib

#: dp_reduce_dtype spellings -> wire dtype (None = the gradient's own)
REDUCE_DTYPES = {"f32": None, "bf16": torch.bfloat16}


class OverlapPlan:
    """Static bucket plan over one built network (the JAX package's):
    ``stages`` are forward-order ``[s0, s1)`` connection ranges, one a
    bucket; ``stage_keys[s]`` / ``tail_keys`` the param-group keys each
    segment produces gradients for (a key can sit in two segments: a
    pool carrying a deferred conv bias); ``frontier`` the node frontier
    entering the loss tail."""

    __slots__ = ("stages", "body_end", "stage_keys", "tail_keys",
                 "frontier", "bucket_bytes")

    def __init__(self, stages, body_end, stage_keys, tail_keys, frontier,
                 bucket_bytes):
        self.stages = stages
        self.body_end = body_end
        self.stage_keys = stage_keys
        self.tail_keys = tail_keys
        self.frontier = frontier
        self.bucket_bytes = bucket_bytes


def group_bytes(group) -> int:
    """Bytes of a (possibly nested) param group."""
    return sum(group_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in group.values())


def _keys_read(net, lo: int, hi: int, params) -> List[str]:
    """Param-group keys the connections in [lo, hi) read: their own key
    plus any deferred-bias key."""
    keys: List[str] = []
    for j in range(lo, hi):
        c = net.connections[j]
        if c.param_key in params and c.param_key not in keys:
            keys.append(c.param_key)
        dk = getattr(c.layer, "deferred_bias_key", None)
        if dk is not None and dk in params and dk not in keys:
            keys.append(dk)
    return keys


def plan_buckets(net, params, bucket_mb: float,
                 eval_ids: Sequence[int]) -> Optional[OverlapPlan]:
    """Partition the graph body into buckets of ~``bucket_mb`` MiB of
    owned (logical) parameters, filled in reverse layer order.  None
    when a train-metric eval node sits before the loss-tail frontier
    (the caller falls back to the implicit step)."""
    from ..nnet import pipeline_net
    conns = net.connections
    assert any(not c.layer.is_loss for c in conns), \
        "dp_overlap: network has no non-loss body"
    body_end = max(i for i, c in enumerate(conns)
                   if not c.layer.is_loss) + 1
    visible = set(pipeline_net.frontier_nodes(net, body_end))
    for c in conns[body_end:]:
        visible.update(c.nindex_out)
    if not set(eval_ids) <= visible:
        return None
    bucket_bytes = max(float(bucket_mb) * 2 ** 20, 1.0)
    owned = {i: group_bytes(params[c.param_key])
             for i, c in enumerate(conns[:body_end])
             if c.owns_params and c.param_key in params}
    cuts: List[int] = []
    acc = 0.0
    # reverse walk: close a bucket once it holds >= the target, cutting
    # BEFORE the connection that filled it
    for i in range(body_end - 1, 0, -1):
        acc += owned.get(i, 0)
        if acc >= bucket_bytes:
            cuts.append(i)
            acc = 0.0
    bounds = [0] + sorted(cuts) + [body_end]
    stages = [(bounds[j], bounds[j + 1]) for j in range(len(bounds) - 1)]
    return OverlapPlan(
        stages=stages, body_end=body_end,
        stage_keys=[_keys_read(net, s0, s1, params) for s0, s1 in stages],
        tail_keys=_keys_read(net, body_end, len(conns), params),
        frontier=pipeline_net.frontier_nodes(net, body_end),
        bucket_bytes=bucket_bytes)


def plan_buckets_of_keys(plan: OverlapPlan) -> List[List[str]]:
    """The buckets in backward order (the tail's first), each key in the
    bucket its gradient completes in: the earliest segment reading it
    (a deferred-bias key's gradient is whole only after both segments'
    backward)."""
    order = [plan.tail_keys] + [plan.stage_keys[s] for s in
                                range(len(plan.stages) - 1, -1, -1)]
    home: Dict[str, int] = {}
    for b, keys in enumerate(order):
        for k in keys:
            home[k] = b
    return [[k for k in keys if home[k] == b]
            for b, keys in enumerate(order)]


class BucketReducer:
    """One step's bucketed reduction, fired from the backward.

    ``leaves`` is ``[(pkey, tag, tensor)]``, the step's parameter
    leaves (each ``requires_grad``); ``buckets`` lists param keys a
    bucket, in backward order.  :meth:`arm` hangs a post-accumulate hook
    on every leaf (:meth:`disarm` takes them off); when a bucket's last
    leaf has its ``.grad``, its collectives are issued asynchronously
    (ZeRO leaves in ``scatter`` reduce-scattered).  :meth:`finish` waits
    for every handle, reduces any leaf the plan missed and returns the
    gradients, ``grads``-nested."""

    def __init__(self, leaves, buckets: List[List[str]], mesh, *,
                 scatter: set, dtype: Optional[torch.dtype]) -> None:
        self.mesh = mesh
        self.scatter = scatter
        self.dtype = dtype
        self.leaves = leaves
        where = {k: b for b, keys in enumerate(buckets) for k in keys}
        self.bucket_of: Dict[int, int] = {}
        self.waiting: Dict[int, int] = {}
        for i, (pkey, _, _) in enumerate(leaves):
            b = where.get(pkey)
            if b is not None:
                self.bucket_of[i] = b
                self.waiting[b] = self.waiting.get(b, 0) + 1
        self.members: Dict[int, List[int]] = {}
        for i, b in self.bucket_of.items():
            self.members.setdefault(b, []).append(i)
        self.pending: Dict[int, meshlib.Pending] = {}
        self._hooks = []

    def arm(self) -> None:
        for i, (_, _, p) in enumerate(self.leaves):
            if i in self.bucket_of:
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    lambda _p, i=i: self._ready(i)))

    def disarm(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def _issue(self, i: int) -> None:
        pkey, tag, p = self.leaves[i]
        g = p.grad
        if (pkey, tag) in self.scatter:
            self.pending[i] = meshlib.reduce_scatter(
                g, self.mesh, "data", dtype=self.dtype, async_op=True)
        else:
            self.pending[i] = meshlib.all_reduce(
                g, self.mesh, "data", dtype=self.dtype, async_op=True)

    def _ready(self, i: int) -> None:
        b = self.bucket_of[i]
        self.waiting[b] -= 1
        if self.waiting[b] == 0:
            for j in self.members[b]:
                self._issue(j)

    def finish(self) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, (pkey, tag, p) in enumerate(self.leaves):
            if i not in self.pending:
                # a leaf outside the plan (or one whose gradient never
                # came): reduced here, never applied unreduced
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                self._issue(i)
            out.setdefault(pkey, {})[tag] = self.pending[i].wait()
        return out


def run_backward(total: torch.Tensor, leaves, *, reducer: Optional[
        BucketReducer], acc: Optional[Dict] = None
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The overlapped backward: ``.grad`` of every leaf starts at its
    ``acc`` entry (the local accumulator a ``dp_reduce_at = apply``
    window folds in) or empty, ``total.backward()`` runs with the
    reducer's hooks armed (``reducer`` None: no reduction, the local
    gradients), and the leaves' gradients come back ``grads``-nested,
    their ``.grad`` cleared."""
    for pkey, tag, p in leaves:
        p.grad = None if acc is None else acc[pkey][tag].clone()
    if reducer is not None:
        reducer.arm()
    try:
        total.backward()
    finally:
        if reducer is not None:
            reducer.disarm()
    if reducer is not None:
        grads = reducer.finish()
    else:
        grads = {}
        for pkey, tag, p in leaves:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.setdefault(pkey, {})[tag] = g
    for _, _, p in leaves:
        p.grad = None
    return grads

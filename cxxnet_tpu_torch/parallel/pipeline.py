"""GPipe and 1F1B pipeline schedules over a ``pipe`` mesh axis (the JAX
package's ``parallel/pipeline.py``).

Where the JAX package runs one SPMD program (a ``lax.scan`` of ticks
inside ``shard_map``, every device holding every stage's code and
switching on its pipe index), the port runs one process a rank: the
rank at index ``s`` of the ``pipe`` axis runs stage ``s`` only, and a
tick's stage handoffs are point-to-point sends on the axis
(:func:`~.mesh.handoff`, the ``lax.ppermute`` of the boundary
buffers): the values a stage sends forward, the cotangents it sends
back.  Every rank can tell from the tick alone what it sends and what
it receives, so each tick posts all of its ops at once in one order.
A receiver knows the shapes it receives from ``specs``, a shape-only
pass of every stage made once by the caller (the JAX package's
``jax.eval_shape`` chain): nothing but values crosses the wire.

Schedules, ``S`` stages, ``M`` microbatches:

* **GPipe** (fill, then drain): stage ``s`` forwards microbatch ``t -
  s`` at tick ``t`` of the ``M + S - 1`` forward ticks, then backwards
  microbatch ``M - 1 - (u - (S - 1 - s))`` at tick ``u`` of as many
  backward ticks (the last microbatch first, as the JAX package's
  autodiff of the scan runs them); every microbatch's graph is alive
  between the two phases.
* **1F1B**: stage ``s`` forwards microbatch ``t - s`` and backwards
  microbatch ``t - (2S - 2 - s)`` at tick ``t`` of ``M + 2S - 2``; the
  last stage backwards a microbatch on the tick it forwards it.  Stage
  ``s`` holds at most ``2(S - 1 - s) + 1`` microbatches in flight,
  whatever ``M``.

A stage's backward is autograd over its own microbatch graph: the
cotangent received from stage ``s + 1`` seeds ``torch.autograd.grad``
on stage ``s``'s outputs (on the last stage the microbatch's loss
does), which yields the parameter gradients, accumulated in float32 in
microbatch order, and the cotangent of the stage's input, sent back.
**The graph of a microbatch is kept in flight** from its forward to its
backward rather than recomputed in the backward as the JAX package
does (``jax.vjp`` at the backward tick): the in-flight bound of 1F1B
holds for kept graphs as for saved inputs, a stage's random masks are
drawn once (on its forward, so both schedules draw the same ones per
microbatch and stage), and no forward runs twice.  The price is a
microbatch's activations, not only its input, for each of the at most
``2(S - 1 - s) + 1`` microbatches in flight.

The scalar aux accumulator (mid-body loss terms: moe load balance, aux
heads) rides every boundary as its last tensor; label fields and masks
do not travel: each rank slices microbatch ``m``'s from its own batch.

Reduction (``reduce`` of :func:`run_schedule`): the accumulators sum
over the given axes (``(pipe, data)``, one merged group) once after the
last tick, or, under 1F1B with ``buckets`` (``dp_overlap = 1``), bucket
by bucket as asynchronous all-reduces issued on the cooldown tick at
which the bucket's owning stage has finished its last backward (the
JAX package's ``reduce_bucket``), over a narrower wire when asked
(``dp_reduce_dtype``; the sum comes back float32).  Both placements sum
the same accumulators over the same group, so at a float32 wire they
are bitwise equal.

:func:`pipeline_apply`, :func:`pipeline_apply_hetero`,
:func:`pipeline_1f1b`, :func:`pipeline_1f1b_hetero` and
:func:`pipeline_train_step` are the JAX package's entry points over
:func:`run_schedule`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import mesh as meshlib

Spec = meshlib.Spec


def value_spec(acts: Sequence[torch.Tensor], aux: torch.Tensor) -> Spec:
    """The wire spec of a boundary value ``(acts, aux)``."""
    return [(tuple(t.shape), t.dtype) for t in (*acts, aux)]


class Result:
    """What :func:`run_schedule` leaves on a rank: ``losses`` (the last
    stage's per-microbatch tail values, detached; empty elsewhere),
    ``keeps`` (the last stage's per-microbatch tail payloads, or its
    output values on a run without a tail), ``grads`` (a float32
    accumulator per leaf, reduced when asked; None on a forward-only
    run), ``live_max`` (the most microbatch graphs this rank held at
    once) and ``handoffs`` (the values it sent)."""

    def __init__(self) -> None:
        self.losses: List[torch.Tensor] = []
        self.keeps: List[Any] = []
        self.grads: Optional[List[torch.Tensor]] = None
        self.live_max = 0
        self.handoffs = 0


def run_schedule(stage_fn: Callable, x_of: Callable, n_micro: int,
                 specs: Sequence[Spec], *, mesh, axis: str = "pipe",
                 schedule: str = "1f1b", train: bool = True,
                 tail_fn: Optional[Callable] = None,
                 batch_loss_fn: Optional[Callable] = None,
                 leaves: Sequence[torch.Tensor] = (),
                 grad_idx: Optional[Sequence[int]] = None,
                 reduce: Optional[Dict] = None) -> Result:
    """Run this rank's stage of an ``S``-stage pipeline over ``n_micro``
    microbatches.

    ``stage_fn(acts, aux, m) -> (acts, aux)`` is stage ``s`` (this
    rank's index on ``axis``) on microbatch ``m``; ``x_of(m)`` the
    acts tuple entering stage 0.  ``specs[s]`` is the wire spec of stage
    ``s``'s output value (:func:`value_spec`).  ``tail_fn(acts, aux,
    m) -> (loss, keep)`` runs on the last stage's output of each
    microbatch: the loss seeds the backward, ``keep`` is collected.
    Under GPipe, ``batch_loss_fn(outs)`` may take its place: one loss of
    the last stage's output values of every microbatch (``[(acts, aux)]``
    in microbatch order), whose cotangents seed the microbatches'
    backwards.

    ``train``: the microbatch graphs are kept and differentiated by
    ``schedule`` (``gpipe`` or ``1f1b``); the gradients of ``leaves``
    (tensors that require grad; ``grad_idx`` the ones this stage reads,
    default all) accumulate in float32.  ``reduce`` (``{"axes",
    "buckets", "dtype"}``) sums them over ``axes``: whole after the last
    tick, or per bucket (``[(leaf indices, owning stage)]``, 1F1B only)
    at the cooldown ticks, the wire in ``dtype`` (None: float32).
    Without ``train``, a forward-only fill under ``no_grad``."""
    n_stage = mesh.axis_size(axis)
    s = mesh.axis_index(axis)
    last = s == n_stage - 1
    dev = mesh.device
    res = Result()
    saved: Dict[int, Tuple] = {}
    fwd_in: Dict[int, List[torch.Tensor]] = {}
    ct_in: Dict[int, List[torch.Tensor]] = {}
    grad_idx = list(range(len(leaves))) if grad_idx is None else list(grad_idx)
    acc: List[Optional[torch.Tensor]] = [None] * len(leaves)

    def forward(m: int) -> Optional[List[torch.Tensor]]:
        if s == 0:
            acts = tuple(x_of(m))
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            vals = fwd_in.pop(m)
            if train:
                vals = [v.requires_grad_() if v.is_floating_point() else v
                        for v in vals]
            acts, aux = tuple(vals[:-1]), vals[-1]
        with torch.set_grad_enabled(train):
            out_acts, out_aux = stage_fn(acts, aux, m)
            loss = keep = None
            if last and tail_fn is not None:
                loss, keep = tail_fn(out_acts, out_aux, m)
        if train:
            ins = [] if s == 0 else [v for v in (*acts, aux)]
            saved[m] = (ins, list(out_acts) + [out_aux], loss)
            res.live_max = max(res.live_max, len(saved))
        if last:
            if loss is not None:
                res.losses.append(loss.detach())
            if tail_fn is not None:
                res.keeps.append(keep)
            elif batch_loss_fn is not None:
                res.keeps.append((list(out_acts), out_aux))
            else:
                res.keeps.append(([a.detach() for a in out_acts],
                                  out_aux.detach()))
            return None
        return [t.detach() for t in (*out_acts, out_aux)]

    def backward(m: int) -> Optional[List[torch.Tensor]]:
        ins, outs, loss = saved.pop(m)
        if last and loss is not None:
            roots, cts = [loss], None
        else:
            cts_all = ct_in.pop(m)
            pairs = [(o, c) for o, c in zip(outs, cts_all)
                     if o.requires_grad]
            roots = [o for o, _ in pairs]
            cts = [c.to(o.dtype) for o, c in pairs]
        wrt = [leaves[i] for i in grad_idx] \
            + [v for v in ins if v.requires_grad]
        if roots and wrt and any(r.requires_grad for r in roots):
            gs = torch.autograd.grad(roots, wrt, grad_outputs=cts,
                                     allow_unused=True)
        else:
            gs = [None] * len(wrt)
        for i, g in zip(grad_idx, gs):
            if g is None:
                continue
            g = g.float()
            acc[i] = g if acc[i] is None else acc[i].add_(g)
        if s == 0:
            return None
        din = iter(gs[len(grad_idx):])
        return [next(din) if v.requires_grad else None for v in ins]

    def exchange(send_f, send_b, recv_f: Optional[int],
                 recv_b: Optional[int]) -> None:
        sends = []
        if send_f is not None:
            sends.append((1, send_f))
        if send_b is not None:
            spec = specs[s - 1]
            sends.append((-1, [g if g is not None else
                               torch.zeros(shape, dtype=dt, device=dev)
                               for g, (shape, dt) in zip(send_b, spec)]))
        recvs, keys = [], []
        if recv_f is not None:
            recvs.append((-1, specs[s - 1]))
            keys.append((fwd_in, recv_f))
        if recv_b is not None:
            recvs.append((1, specs[s]))
            keys.append((ct_in, recv_b))
        if not sends and not recvs:
            return
        res.handoffs += len(sends)
        got = meshlib.handoff(mesh, axis, sends, recvs)
        for (into, m), vals in zip(keys, got):
            into[m] = vals

    def valid(m: int) -> Optional[int]:
        return m if 0 <= m < n_micro else None

    pending: Dict[int, meshlib.Pending] = {}
    buckets = (reduce or {}).get("buckets")

    def reduce_leaf(i: int, async_op: bool):
        if acc[i] is None:
            acc[i] = torch.zeros(leaves[i].shape, dtype=torch.float32,
                                 device=leaves[i].device)
        return meshlib.all_reduce(acc[i], mesh, reduce["axes"],
                                  dtype=reduce.get("dtype"),
                                  async_op=async_op)

    if not train:
        with torch.no_grad():
            for t in range(n_micro + n_stage - 1):
                mf = valid(t - s)
                out = forward(mf) if mf is not None else None
                exchange(out if not last else None, None,
                         valid(t - s + 1) if s > 0 else None, None)
        return res
    if schedule == "gpipe":
        ticks = n_micro + n_stage - 1
        for t in range(ticks):
            mf = valid(t - s)
            out = forward(mf) if mf is not None else None
            exchange(out, None, valid(t - s + 1) if s > 0 else None, None)
        if last and batch_loss_fn is not None:
            loss = batch_loss_fn(res.keeps)
            res.losses.append(loss.detach())
            outs = [(m, j, o) for m in range(n_micro)
                    for j, o in enumerate(saved[m][1])]
            need = [(m, j, o) for m, j, o in outs if o.requires_grad]
            cts = torch.autograd.grad(loss, [o for _, _, o in need],
                                      allow_unused=True)
            for m in range(n_micro):
                ct_in[m] = [torch.zeros_like(o) for o in saved[m][1]]
            for (m, j, _), g in zip(need, cts):
                if g is not None:
                    ct_in[m][j] = g
            res.keeps = [([a.detach() for a in acts], aux.detach())
                         for acts, aux in res.keeps]
        for u in range(ticks):
            mb = valid(n_micro - 1 - (u - (n_stage - 1 - s)))
            dx = backward(mb) if mb is not None else None
            exchange(None, dx, None,
                     valid(n_micro - 1 - (u - (n_stage - 2 - s)))
                     if not last else None)
    elif schedule == "1f1b":
        ticks = n_micro + 2 * n_stage - 2
        for t in range(ticks):
            mf = valid(t - s)
            out = forward(mf) if mf is not None else None
            mb = valid(t - (2 * n_stage - 2 - s))
            dx = backward(mb) if mb is not None else None
            exchange(out, dx, valid(t - s + 1) if s > 0 else None,
                     valid(t - (2 * n_stage - 3 - s)) if not last else None)
            k = t - (ticks - n_stage)
            if buckets is not None and k >= 0:
                # cooldown tick k: stage S-1-k has run its last backward
                for idx, owner in buckets:
                    if owner == n_stage - 1 - k:
                        for i in idx:
                            pending[i] = reduce_leaf(i, True)
    else:
        raise ValueError(f"pipe_schedule = {schedule}: expected gpipe or "
                         "1f1b")
    if reduce is not None:
        # the rest of the tree in one burst: every reduction issued, then
        # each waited on in leaf order
        for i in range(len(leaves)):
            if i not in pending:
                pending[i] = reduce_leaf(i, True)
        for i in range(len(leaves)):
            acc[i] = pending[i].wait()
    res.grads = [a if a is not None else
                 torch.zeros(leaves[i].shape, dtype=torch.float32,
                             device=leaves[i].device)
                 for i, a in enumerate(acc)]
    return res


def boundary_specs(stage_fns: Sequence[Callable], acts0: Sequence[torch.Tensor]
                   ) -> List[Spec]:
    """``specs[s]``, the wire spec of stage ``s``'s output value, from a
    shape-only pass of every stage in turn on ``acts0`` (meta tensors,
    or any tensors: the values are not read), under ``no_grad``."""
    specs = []
    acts, aux = tuple(acts0), torch.zeros((), dtype=torch.float32,
                                          device=acts0[0].device)
    with torch.no_grad():
        for s, fn in enumerate(stage_fns):
            acts, aux = fn(acts, aux, 0)
            specs.append(value_spec(acts, aux))
    return specs


def broadcast_last(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The last stage's ``t`` on every rank of ``axis``."""
    return meshlib.broadcast(t, mesh, axis, src=mesh.axis_size(axis) - 1)


def _stacked(keeps, n_stage_last: bool, spec: Spec, n_micro: int, mesh,
             axis: str) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The last stage's per-microbatch output values stacked on a leading
    microbatch dim, broadcast over ``axis`` (every rank returns them,
    as the JAX package's outputs are replicated)."""
    if n_stage_last:
        acts = tuple(torch.stack([k[0][j] for k in keeps])
                     for j in range(len(spec) - 1))
        aux = torch.stack([k[1] for k in keeps])
    else:
        acts = tuple(torch.zeros((n_micro,) + shape, dtype=dt,
                                 device=mesh.device)
                     for shape, dt in spec[:-1])
        aux = torch.zeros((n_micro,), dtype=torch.float32,
                          device=mesh.device)
    return (tuple(broadcast_last(a, mesh, axis) for a in acts),
            broadcast_last(aux, mesh, axis))


def pipeline_apply_hetero(stage_fns: Sequence[Callable], x: torch.Tensor, *,
                          mesh, axis: str = "pipe"
                          ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """GPipe forward over heterogeneous stages: ``stage_fns[s](acts, aux,
    m) -> (acts, aux)`` (acts a tuple of frontier values, aux the loss
    accumulator), ``x`` the ``(n_micro, mb, ...)`` microbatches entering
    stage 0.  Returns ``(outs, aux_losses)``: the last stage's output
    values stacked ``(n_micro, mb, ...)`` and its ``(n_micro,)`` aux
    totals, on every rank of ``axis``.  Gradients: :func:`run_schedule`
    with ``schedule = "gpipe"``."""
    n_micro = x.shape[0]
    specs = boundary_specs(stage_fns, (x[0],))
    s = mesh.axis_index(axis)
    res = run_schedule(stage_fns[s], lambda m: (x[m],), n_micro, specs,
                       mesh=mesh, axis=axis, train=False)
    last = s == mesh.axis_size(axis) - 1
    return _stacked(res.keeps, last, specs[-1], n_micro, mesh, axis)


def pipeline_apply(stage_fn: Callable, params, x: torch.Tensor, *, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Shape-preserving stages, ``stage_fn(p, mb) -> mb``, with this
    rank's stage's ``params`` (the JAX package's stacked parameters'
    slice at the rank's pipe index): ``x`` ``(n_micro, mb, ...)`` through
    every stage, the last stage's outputs ``(n_micro, mb, ...)`` on every
    rank."""
    fns = [lambda acts, aux, m: ((stage_fn(params, acts[0]),), aux)] \
        * mesh.axis_size(axis)
    (out,), _ = pipeline_apply_hetero(fns, x, mesh=mesh, axis=axis)
    return out


def pipeline_1f1b_hetero(stage_fns: Sequence[Callable], tail_loss_fn,
                         leaves: Sequence[torch.Tensor], x: torch.Tensor, *,
                         mesh, axis: str = "pipe", schedule: str = "1f1b",
                         grad_idx=None, reduce: Optional[Dict] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    Result]:
    """Loss and gradients of a heterogeneous pipeline: stage functions as
    :func:`pipeline_apply_hetero`'s, ``tail_loss_fn(acts, aux, m)`` the
    scalar loss of the last stage's output for microbatch ``m``,
    ``leaves`` the tensors to differentiate (requiring grad).  Returns
    ``(loss, grads, result)``: the sum of the per-microbatch losses in
    microbatch order on every rank of ``axis``, a float32 gradient a
    leaf summed over the stages (and over ``reduce``'s axes when
    given: ``reduce["axes"]`` must hold ``axis``), and the
    :class:`Result`."""
    n_micro = x.shape[0]
    specs = boundary_specs(stage_fns, (x[0],))
    s = mesh.axis_index(axis)
    red = reduce or {"axes": (axis,), "buckets": None, "dtype": None}
    res = run_schedule(stage_fns[s], lambda m: (x[m],), n_micro, specs,
                       mesh=mesh, axis=axis, schedule=schedule,
                       tail_fn=lambda a, aux, m: (tail_loss_fn(a, aux, m),
                                                  None),
                       leaves=leaves, grad_idx=grad_idx, reduce=red)
    return total_loss(res, mesh, axis), res.grads, res


def total_loss(res: Result, mesh, axis: str = "pipe") -> torch.Tensor:
    """The sum of the last stage's per-microbatch losses, in microbatch
    order, broadcast from it over ``axis``."""
    if res.losses:
        loss = res.losses[0].float()
        for v in res.losses[1:]:
            loss = loss + v.float()
    else:
        loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    return broadcast_last(loss, mesh, axis)


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable,
                  params: Dict[str, torch.Tensor], x: torch.Tensor,
                  labels: torch.Tensor, *, mesh, axis: str = "pipe",
                  schedule: str = "1f1b"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shape-preserving stages under 1F1B (or ``schedule = "gpipe"``):
    ``stage_fn(p, mb)`` with this rank's stage's ``params`` (tensors),
    ``loss_fn(y, lab)`` the last stage's microbatch loss.  Returns
    ``(loss, grads)``: the sum of the per-microbatch losses on every
    rank, and the gradients of this rank's stage's parameters (float32,
    the JAX package's per-stage slice of its stacked gradients)."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    p = dict(zip(names, leaves))
    fns = [lambda acts, aux, m: ((stage_fn(p, acts[0]),), aux)] \
        * mesh.axis_size(axis)
    loss, grads, _ = pipeline_1f1b_hetero(
        fns, lambda acts, aux, m: loss_fn(acts[0], labels[m]), leaves, x,
        mesh=mesh, axis=axis, schedule=schedule,
        reduce={"axes": (), "buckets": None, "dtype": None})
    return loss, dict(zip(names, grads))


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                        params: Dict[str, torch.Tensor], x: torch.Tensor,
                        labels: torch.Tensor, *, mesh, axis: str = "pipe",
                        lr: float = 0.1
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One pipelined SGD step under GPipe: forward through the stages,
    ``loss_fn(outs, labels)`` on the last stage's ``(n_micro, mb, ...)``
    outputs, backward through the reverse pipeline, ``p - lr * g`` on
    this rank's stage (``params``).  Returns ``(new_params, loss)``, the
    loss on every rank."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    p = dict(zip(names, leaves))
    fns = [lambda acts, aux, m: ((stage_fn(p, acts[0]),), aux)] \
        * mesh.axis_size(axis)
    specs = boundary_specs(fns, (x[0],))
    res = run_schedule(
        fns[mesh.axis_index(axis)], lambda m: (x[m],), x.shape[0], specs,
        mesh=mesh, axis=axis, schedule="gpipe",
        batch_loss_fn=lambda outs: loss_fn(
            torch.stack([acts[0] for acts, _ in outs]), labels),
        leaves=leaves, reduce={"axes": (), "buckets": None, "dtype": None})
    return ({k: (params[k] - lr * g.to(params[k].dtype)).detach()
             for k, g in zip(names, res.grads)}, total_loss(res, mesh, axis))

"""Graph partition of a netconfig net into contiguous stages and the
stages' forward functions (the JAX package's ``nnet/pipeline_net.py``):
``remat = K`` checkpoints each of K segments
(``NetTrainer._remat_forward``), ``mesh = ...,pipe:K`` runs stage s on
the ranks at index s of the ``pipe`` axis (``parallel/pipeline.py``).

A cut may fall anywhere: the boundary carries the frontier, every node
still live across it (one node at a pool or a flatten, several across an
inception module's branches or a skip connection).  The trailing loss
layers run after the last stage; loss layers inside the body (the aux
heads, the moe layers' load balance) stay in it, and their terms ride
the boundary as a scalar accumulator (:func:`make_stage_fns`).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from ..layers.conv import ConvolutionLayer
from ..layers.fullc import FullConnectLayer


def _conn_cost(net, ci: int) -> float:
    """A connection's operation estimate for balancing: a conv's or a
    fullc's multiply-adds, else its output size."""
    conn = net.connections[ci]
    out_shape = net.node_shapes[conn.nindex_out[0]]
    layer = conn.layer
    if isinstance(layer, ConvolutionLayer):
        n, co, oh, ow = out_shape
        ci_ = net.node_shapes[conn.nindex_in[0]][1]
        p = layer.param
        return (2.0 * n * co * oh * ow * (ci_ // p.num_group)
                * p.kernel_height * p.kernel_width)
    if isinstance(layer, FullConnectLayer):
        nin = net.node_shapes[conn.nindex_in[0]]
        return 2.0 * nin[0] * nin[1] * nin[2] * nin[3] * layer.param.num_hidden
    return float(out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3])


def _last_use(net):
    lu = {}
    for i, c in enumerate(net.connections):
        for n in c.nindex_in:
            lu[n] = i
    return lu


def _graph_inputs(net) -> List[int]:
    """Nodes read before any connection writes them (the data node and
    the extra-data nodes)."""
    produced, inputs = set(), []
    for c in net.connections:
        for n in c.nindex_in:
            if n not in produced and n not in inputs:
                inputs.append(n)
        produced.update(c.nindex_out)
    return inputs


def frontier_nodes(net, end: int) -> List[int]:
    """The nodes live across the cut before connection ``end``, graph
    inputs first, then in the order their writers run."""
    lu = _last_use(net)
    live = [n for n in _graph_inputs(net) if lu.get(n, -1) >= end]
    for j in range(end):
        for n in net.connections[j].nindex_out:
            if lu.get(n, -1) >= end and n not in live:
                live.append(n)
    return live


def partition_network(net, n_stage: int
                      ) -> Tuple[List[Tuple[int, int]], int]:
    """``(stages, body_end)``: ``n_stage`` contiguous ``[start, end)``
    ranges over ``net.connections`` that cover the body, and the index
    of the first trailing loss connection, which runs after them.

    Cuts balance the operation estimate: among the cuts within a quarter
    stage of a target, the narrowest frontier wins, the distance to the
    target breaks ties.  A net whose body keeps running buffers
    (batch_norm) is refused: buffer updates do not cross a partition."""
    conns = net.connections
    assert any(not c.layer.is_loss for c in conns), \
        "graph partition: network has no non-loss body"
    body_end = max(i for i, c in enumerate(conns)
                   if not c.layer.is_loss) + 1
    for c in conns[:body_end]:
        if c.layer.is_loss:
            continue
        nb = c.layer.init_buffers(
            [net.node_shapes[n] for n in c.nindex_in], "cpu")
        assert not nb, (
            f"graph partition (pipe/remat): layer {c.layer.type_names[0]} "
            "keeps running buffers (e.g. batch_norm moving stats); buffer "
            "updates don't thread through partitioned execution yet")
    costs = [_conn_cost(net, i) for i in range(body_end)]
    total = sum(costs)
    prefix, acc = [], 0.0
    for c in costs:
        acc += c
        prefix.append(acc)
    fsize = {i: len(frontier_nodes(net, i + 1)) for i in range(body_end - 1)}
    cuts = []
    avail = list(range(body_end - 1))
    for k in range(1, n_stage):
        target = total * k / n_stage
        assert avail, (
            f"graph partition (pipe/remat): too few cut points for "
            f"{n_stage} segments ({body_end} body connections)")
        tol = 0.25 * total / n_stage
        near = [i for i in avail if abs(prefix[i] - target) <= tol]
        pool = near or avail
        best = min(pool, key=lambda i: (fsize[i] if near else 0,
                                        abs(prefix[i] - target)))
        cuts.append(best)
        avail = [i for i in avail if i > best]
    bounds = [0] + [c + 1 for c in cuts] + [body_end]
    return [(bounds[i], bounds[i + 1]) for i in range(n_stage)], body_end


def run_conns(net, params, lo: int, hi: int, env, ctx):
    """Connections ``[lo, hi)`` one by one over the node dict ``env``
    (no sibling-fuse or virtual-concat peephole, as in the JAX package's
    segments); an armed ``net.mem_probe`` reads the allocator after
    each.  Returns ``env``."""
    from .net import conn_params
    for j in range(lo, hi):
        conn = net.connections[j]
        outs = conn.layer.forward(conn_params(params, conn),
                                  [env[n] for n in conn.nindex_in], ctx)
        for n, v in zip(conn.nindex_out, outs):
            env[n] = v
        if net.mem_probe is not None:
            net.mem_probe.mark(net.scope_names[j])
    return env


def make_stage_fns(net, stages, ctx_of: Callable) -> List[Callable]:
    """``stage_fns[s](params, acts, aux, m) -> (acts, aux)``: stage
    ``s`` on microbatch ``m``.  ``acts`` is the tuple of the frontier
    values entering the stage (:func:`frontier_nodes` order), ``aux`` the
    scalar accumulator of the loss terms raised in the body before it:
    the stage adds its own (``aux + l1 + l2 ...``, in the order they were
    raised), so mid-body loss layers survive a partition.  ``ctx_of(m)``
    makes the stage's :class:`~..layers.base.ForwardContext`: microbatch
    ``m``'s label fields and loss mask, which mid-body loss layers read
    (the JAX package's ``extra``), and the generator its masks draw
    from."""
    in_nodes = [frontier_nodes(net, s0) for s0, _ in stages]
    out_nodes = [frontier_nodes(net, s1) for _, s1 in stages]

    def mk(s: int, s0: int, s1: int):
        def fn(params, acts, aux, m: int = 0):
            ctx = ctx_of(m)
            env = run_conns(net, params, s0, s1, dict(zip(in_nodes[s], acts)),
                            ctx)
            for loss in ctx.losses:
                aux = aux + loss
            return tuple(env[n] for n in out_nodes[s]), aux
        return fn

    return [mk(s, s0, s1) for s, (s0, s1) in enumerate(stages)]

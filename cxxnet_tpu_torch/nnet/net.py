"""Network graph: layer instantiation, shape inference, forward.

The JAX package's ``nnet/net.py`` in PyTorch: connections bind layer
instances to node ids in declaration order, shapes are inferred once,
and ``forward`` runs the connections over a node list (self-loop layers
rebind their node).  ``share[tag]`` connections reuse the primary's
layer and parameter group.  A max pool that carries a conv's deferred
bias (the trainer's relu/bias -> pool reorder) reads that bias from the
conv's group as ``deferred_bias`` (:func:`conn_params`).

Running buffers (``{param_key: {tag: tensor}}``, batch_norm's moving
statistics) go through :meth:`Network.run` and come back updated; a
shared connection updates its primary's group, and the next use reads
the chained update (last write wins).  Two peepholes the trainer sets
up change how connections execute, not what they compute:
``conv_sibling_fuse = 1`` (``fuse_groups``: convs of one input and one
geometry run as one conv, :meth:`Network._forward_fused`) and
``concat_virtual = 1`` (a ch_concat's value stays a
:class:`~..layers.base.ChSegs`, :meth:`Network._virtual_forward`).

While a profile window is open (``profile_scopes``, set by the
trainer's :class:`~..monitor.trace.ProfileWindow`), :meth:`Network.run`
enters a ``torch.profiler.record_function`` range named
:func:`~..layers.base.conn_scope_name` around each connection's forward,
the ranges layer attribution joins kernels against; outside a window it
enters none.  On one step of such a window an armed ``mem_probe``
(``monitor/memory.AllocProbe``) reads the allocator after each
connection's forward (under ``remat`` the trainer's segments read it
in its place).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import record_function

from ..layers.base import ChSegs, ForwardContext, Layer, Shape4, \
    conn_scope_name, materialize
from ..layers.registry import create_layer
from ..layers.shape_ops import SplitLayer
from .netconfig import NetConfig, global_pairs

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class Connection:
    layer: Layer
    nindex_in: List[int]
    nindex_out: List[int]
    param_key: str          # shared connections carry the primary's key
    owns_params: bool


class Network:
    """Static graph built from a NetConfig; parameters live outside."""

    def __init__(self, cfg: NetConfig, batch_size: int,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.batch_size = batch_size
        self.dtype = dtype
        self.connections: List[Connection] = []
        self.node_shapes: List[Optional[Shape4]] = [None] * cfg.num_nodes
        self._build()
        self._infer_shapes()
        # input nodes read as integer ids stay float32 (a bf16 cast
        # would round ids above 256)
        self.id_inputs = {n for c in self.connections if c.layer.takes_ids
                          for n in c.nindex_in}
        # conv_sibling_fuse = 1 (the trainer's _fuse_sibling_convs): the
        # group head's index -> the member indices, and the members the
        # head runs
        self.fuse_groups: Dict[int, List[int]] = {}
        self.fuse_skip = frozenset()
        # a record_function range per connection while a profile window
        # is open
        self.profile_scopes = False
        # an armed monitor/memory.AllocProbe reads the allocator after
        # each connection's forward (one step of a profile window)
        self.mem_probe = None
        self.scope_names = [conn_scope_name(i, c)
                            for i, c in enumerate(self.connections)]

    def _layer_key(self, index: int, info) -> str:
        base = info.name if info.name else info.type_name
        return f"{index:02d}-{base}"

    def _build(self) -> None:
        cfg = self.cfg
        for i, info in enumerate(cfg.layers):
            if info.is_shared:
                primary = self.connections[info.primary_layer_index]
                self.connections.append(Connection(
                    layer=primary.layer, nindex_in=list(info.nindex_in),
                    nindex_out=list(info.nindex_out),
                    param_key=primary.param_key, owns_params=False))
                continue
            layer = create_layer(info.type_name)
            layer.name = info.name
            if isinstance(layer, SplitLayer):
                layer.num_out = len(info.nindex_out)
            # global keys first, then the layer's own section
            for k, v in global_pairs(cfg.defcfg):
                layer.set_param(k, v)
            for k, v in cfg.layercfg[i]:
                layer.set_param(k, v)
            self.connections.append(Connection(
                layer=layer, nindex_in=list(info.nindex_in),
                nindex_out=list(info.nindex_out),
                param_key=self._layer_key(i, info), owns_params=True))

    def _infer_shapes(self) -> None:
        cfg = self.cfg
        assert cfg.input_shape is not None, "input_shape must be configured"
        c, y, x = cfg.input_shape
        self.node_shapes[0] = (self.batch_size, c, y, x)
        for i in range(cfg.extra_data_num):
            ec, ey, ex = cfg.extra_shape[3 * i: 3 * i + 3]
            self.node_shapes[1 + i] = (self.batch_size, ec, ey, ex)
        for conn in self.connections:
            in_shapes = []
            for nid in conn.nindex_in:
                assert self.node_shapes[nid] is not None, (
                    f"node {cfg.node_names[nid]!r} used before being produced")
                in_shapes.append(self.node_shapes[nid])
            out_shapes = conn.layer.infer_shapes(in_shapes)
            assert len(out_shapes) == len(conn.nindex_out), (
                f"layer {conn.layer.type_names[0]} produced {len(out_shapes)} "
                f"outputs for {len(conn.nindex_out)} output nodes")
            for nid, s in zip(conn.nindex_out, out_shapes):
                self.node_shapes[nid] = s

    def init_params(self, seed: int, device: torch.device) -> Params:
        """Fresh parameters from ``seed``: connection ``i`` draws from its
        own ``torch.Generator`` seeded ``seed * 1000003 + i`` on
        ``device``, so one layer's init does not depend on another's.  On
        ``meta`` the parameters are meta tensors: their shapes and
        dtypes, no values."""
        if device.type == "meta":
            # a meta generator does not exist: draw "from" a CPU one with
            # every tensor made on meta (shapes and dtypes, no storage)
            with _OnMeta():
                return self.init_params(seed, torch.device("cpu"))
        params: Params = {}
        for i, conn in enumerate(self.connections):
            if not conn.owns_params:
                continue
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 1000003 + i)
            in_shapes = [self.node_shapes[n] for n in conn.nindex_in]
            p = conn.layer.init_params(gen, in_shapes, self.dtype)
            if p:
                params[conn.param_key] = p
        return params

    def init_buffers(self, device: torch.device) -> Params:
        """Each layer's running buffers (float32, on ``device``)."""
        buffers: Params = {}
        for conn in self.connections:
            if not conn.owns_params:
                continue
            b = conn.layer.init_buffers(
                [self.node_shapes[n] for n in conn.nindex_in], device)
            if b:
                buffers[conn.param_key] = b
        return buffers

    def forward(self, params: Params, inputs: Dict[int, torch.Tensor],
                ctx: ForwardContext, until: Optional[int] = None,
                buffers: Optional[Params] = None) -> List:
        """:meth:`run`'s node list (the new buffers dropped)."""
        return self.run(params, buffers or {}, inputs, ctx, until)[0]

    def run(self, params: Params, buffers: Params,
            inputs: Dict[int, torch.Tensor], ctx: ForwardContext,
            until: Optional[int] = None) -> Tuple[List, Params]:
        """Run the connections in declaration order; return the node list
        and the updated buffers.  ``until`` stops BEFORE connection
        ``until`` — the decode engine reads raw LM-head logits without
        the softmax self-loop.  Under ``concat_virtual = 1`` a node may
        hold a :class:`ChSegs` (:func:`~..layers.base.materialize`)."""
        nodes: List = [None] * self.cfg.num_nodes
        for nid, v in inputs.items():
            want = torch.float32 if nid in self.id_inputs else self.dtype
            nodes[nid] = v.to(want)
        new_buffers = dict(buffers)
        scoped = self.profile_scopes
        for i, conn in enumerate(self.connections):
            if until is not None and i >= until:
                break
            if i in self.fuse_skip:
                continue
            if scoped:
                with record_function(self.scope_names[i]):
                    self._run_conn(i, conn, params, new_buffers, nodes, ctx)
            else:
                self._run_conn(i, conn, params, new_buffers, nodes, ctx)
            if self.mem_probe is not None:
                self.mem_probe.mark(self.scope_names[i])
        return nodes, new_buffers

    def _run_conn(self, i: int, conn: Connection, params: Params,
                  new_buffers: Params, nodes, ctx: ForwardContext) -> None:
        """Connection ``i``'s forward into ``nodes`` (a fused group's
        head runs the group)."""
        if i in self.fuse_groups:
            self._forward_fused(self.fuse_groups[i], params, nodes, ctx)
            return
        if ctx.opts.concat_virtual == "1" \
                and self._virtual_forward(conn, params, nodes, ctx):
            return
        ins = [materialize(nodes[n]) for n in conn.nindex_in]
        outs, nb = conn.layer.forward_buffers(
            conn_params(params, conn),
            new_buffers.get(conn.param_key, {}), ins, ctx)
        if nb:
            new_buffers[conn.param_key] = nb
        for n, v in zip(conn.nindex_out, outs):
            nodes[n] = v

    def _virtual_forward(self, conn: Connection, params: Params, nodes,
                         ctx: ForwardContext) -> bool:
        """``concat_virtual = 1``: run ``conn`` on channel segments where
        its layer takes them, and return whether it did.  A ch_concat
        makes a :class:`ChSegs`; split passes it on; channelwise pools
        map over its segments; an ungrouped conv takes it as a sum of
        convs (:func:`conv_over_segs`)."""
        from ..layers.conv import (AvgPoolingLayer, ConvolutionLayer,
                                   MaxPoolingLayer, SumPoolingLayer)
        from ..layers.shape_ops import ChConcatLayer
        from ..ops import nn as N
        layer = conn.layer
        if type(layer) is ChConcatLayer and len(conn.nindex_out) == 1:
            segs = []
            for n in conn.nindex_in:
                v = nodes[n]
                segs.extend(v.segs if isinstance(v, ChSegs) else [v])
            nodes[conn.nindex_out[0]] = ChSegs(segs)
            return True
        if len(conn.nindex_in) != 1 or not conn.nindex_out:
            return False
        v = nodes[conn.nindex_in[0]]
        if not isinstance(v, ChSegs):
            return False
        p = layer.param
        if type(layer) is SplitLayer:
            for n in conn.nindex_out:
                nodes[n] = v
            return True
        if (type(layer) is ConvolutionLayer and p.num_group == 1
                and not layer.space_to_depth and not layer.s2d_input):
            group = params[conn.param_key]
            out = conv_over_segs(v.segs, group["wmat"], p.stride, p.pad_y,
                                 p.pad_x)
            if "bias" in group and not layer.defer_bias:
                out = out + group["bias"].to(out.dtype).reshape(1, -1, 1, 1)
            nodes[conn.nindex_out[0]] = out
            return True
        pools = {MaxPoolingLayer: N.max_pool2d, AvgPoolingLayer: N.avg_pool2d,
                 SumPoolingLayer: N.sum_pool2d}
        if (type(layer) in pools
                and getattr(layer, "deferred_bias_key", None) is None):
            geom = (p.kernel_height, p.kernel_width, p.stride, p.pad_y,
                    p.pad_x)
            if type(layer) is MaxPoolingLayer:
                segs = [N.max_pool2d(s, *geom, opts=ctx.opts)
                        for s in v.segs]
                if layer.relu_after:
                    segs = [N.relu(s, ctx.opts) for s in segs]
            else:
                segs = [pools[type(layer)](s, *geom) for s in v.segs]
            nodes[conn.nindex_out[0]] = ChSegs(segs)
            return True
        return False

    def _forward_fused(self, members: List[int], params: Params, nodes,
                       ctx: ForwardContext) -> None:
        """A ``conv_sibling_fuse`` group as one conv: the members read one
        value with one geometry, so their weights (and biases) join on
        the output channels; each member's output is its channel slice.
        Each member keeps its own parameters: autograd slices the fused
        gradient back."""
        from ..ops import nn as N
        mconns = [self.connections[j] for j in members]
        x = nodes[mconns[0].nindex_in[0]]
        p0 = mconns[0].layer.param
        w = torch.cat([params[c.param_key]["wmat"] for c in mconns], dim=0)
        if isinstance(x, ChSegs):
            out = conv_over_segs(x.segs, w, p0.stride, p0.pad_y, p0.pad_x)
        else:
            out = N.conv2d(x, w, stride=p0.stride, pad_y=p0.pad_y,
                           pad_x=p0.pad_x)
        if "bias" in params[mconns[0].param_key]:
            b = torch.cat([params[c.param_key]["bias"] for c in mconns])
            out = out + b.to(out.dtype).reshape(1, -1, 1, 1)
        off = 0
        for c in mconns:
            co = c.layer.param.num_channel
            nodes[c.nindex_out[0]] = out[:, off:off + co]
            off += co

    def node_id(self, name: str) -> int:
        if name.startswith("top[") and name.endswith("]"):
            k = int(name[4:-1])
            last = self.connections[-1].nindex_out[-1]
            return last + 1 + k if k < 0 else k
        if name in self.cfg.node_name_map:
            return self.cfg.node_name_map[name]
        raise KeyError(f"unknown node name {name!r}")

    @property
    def final_node(self) -> int:
        return self.connections[-1].nindex_out[-1]

    def describe(self) -> str:
        lines = []
        for i, conn in enumerate(self.connections):
            ins = ",".join(self.cfg.node_names[n] for n in conn.nindex_in)
            outs = ",".join(self.cfg.node_names[n] for n in conn.nindex_out)
            shapes = [self.node_shapes[n] for n in conn.nindex_out]
            share = " (shared)" if not conn.owns_params else ""
            lines.append(f"{i:3d} {conn.layer.type_names[0]:>20s}{share} "
                         f"[{ins} -> {outs}] out={shapes}")
        return "\n".join(lines)


class _OnMeta(TorchFunctionMode):
    """Every tensor a factory call makes with a ``device`` argument is
    made on ``meta`` (the layers place their parameters on their
    generator's device)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = dict(kwargs, device="meta")
        return func(*args, **kwargs)


def conv_over_segs(segs: List[torch.Tensor], w: torch.Tensor, stride: int,
                   pad_y: int, pad_x: int) -> torch.Tensor:
    """conv(concat(segs), w) as the sum of each segment's conv with its
    slice of w's input channels: the consumer side of the virtual
    concat, whose backward hands each segment its own gradient."""
    from ..ops import nn as N
    out, off = None, 0
    for s in segs:
        ci = s.shape[1]
        o = N.conv2d(s, w[:, off:off + ci], stride=stride, pad_y=pad_y,
                     pad_x=pad_x)
        out = o if out is None else out + o
        off += ci
    assert off == w.shape[1], (off, tuple(w.shape))
    return out


def conn_params(params: Params, conn: Connection) -> Dict[str, torch.Tensor]:
    """One connection's parameters.  A max pool carrying a deferred conv
    bias gets it under "deferred_bias"; the tensor stays in the conv's
    group, so gradients, the updater and snapshots are untouched."""
    p = params.get(conn.param_key, {})
    key = getattr(conn.layer, "deferred_bias_key", None)
    if key is not None:
        p = dict(p, deferred_bias=params[key]["bias"])
    return p

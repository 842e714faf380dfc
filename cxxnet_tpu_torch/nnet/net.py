"""Network graph: layer instantiation, shape inference, forward.

The JAX package's ``nnet/net.py`` in PyTorch: connections bind layer
instances to node ids in declaration order, shapes are inferred once,
and ``forward`` runs the connections over a node list (self-loop layers
rebind their node).  ``share[tag]`` connections reuse the primary's
layer and parameter group.  A max pool that carries a conv's deferred
bias (the trainer's relu/bias -> pool reorder) reads that bias from the
conv's group as ``deferred_bias`` (:func:`conn_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..layers.base import ForwardContext, Layer, Shape4
from ..layers.registry import create_layer
from ..layers.shape_ops import SplitLayer
from .netconfig import NetConfig

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
            for k, v in cfg.defcfg:
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
        ``device``, so one layer's init does not depend on another's."""
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

    def forward(self, params: Params, inputs: Dict[int, torch.Tensor],
                ctx: ForwardContext, until: Optional[int] = None
                ) -> List[Optional[torch.Tensor]]:
        """Run the connections in declaration order and return the node
        list.  ``until`` stops BEFORE connection ``until`` — the decode
        engine reads raw LM-head logits without the softmax self-loop."""
        nodes: List[Optional[torch.Tensor]] = [None] * self.cfg.num_nodes
        for nid, v in inputs.items():
            want = torch.float32 if nid in self.id_inputs else self.dtype
            nodes[nid] = v.to(want)
        for i, conn in enumerate(self.connections):
            if until is not None and i >= until:
                break
            ins = [nodes[n] for n in conn.nindex_in]
            outs = conn.layer.forward(conn_params(params, conn), ins, ctx)
            for n, v in zip(conn.nindex_out, outs):
                nodes[n] = v
        return nodes

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


def conn_params(params: Params, conn: Connection) -> Dict[str, torch.Tensor]:
    """One connection's parameters.  A max pool carrying a deferred conv
    bias gets it under "deferred_bias"; the tensor stays in the conv's
    group, so gradients, the updater and snapshots are untouched."""
    p = params.get(conn.param_key, {})
    key = getattr(conn.layer, "deferred_bias_key", None)
    if key is not None:
        p = dict(p, deferred_bias=params[key]["bias"])
    return p

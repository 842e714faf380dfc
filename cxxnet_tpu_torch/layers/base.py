"""Layer core: plain functions on tensors over 4-D nodes.

A layer holds only its static configuration.  Its parameters live in
the trainer's ``{param_key: {tag: tensor}}`` dict — the JAX package's
layout, tags ``wmat`` / ``bias`` / ``wqkv`` / ... — so snapshots and
parity tests line up key for key.  ``forward(params, inputs, ctx)``
returns the output tensors; a training forward runs under autograd, and
loss layers append their scalar terms to ``ctx.losses``.  A layer with
running buffers (``batch_norm``'s moving statistics, ``fixconn``'s
table) makes them in ``init_buffers`` and overrides ``forward_buffers``,
which returns its outputs and its new buffers.

Under ``concat_virtual = 1`` a ``ch_concat`` node holds a :class:`ChSegs`
(its branch segments) instead of one tensor; a layer that does not take
segments gets them concatenated (:func:`materialize`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.schema import K, KeySpec
from ..engine import EngineOptions

Shape4 = Tuple[int, int, int, int]  # (batch, channel, y, x)
Params = Dict[str, torch.Tensor]

# ``strict_config = 1`` (global key, default off): a key that reaches the
# base ``set_param`` unconsumed is reported through the lint reporter
# (``analysis/conflint.report_ignored_layer_key``) instead of dropped
# silently.  The reference rule (components ignore keys they do not
# know) stays the default, since globals reach every layer.
_STRICT_CONFIG = False


def set_strict_config(flag: bool) -> None:
    global _STRICT_CONFIG
    _STRICT_CONFIG = bool(flag)
    # a fresh dedup window per toggle: a net built under a new
    # strict_config = 1 warns again for the same (type, key)
    import sys
    conflint = sys.modules.get("cxxnet_tpu_torch.analysis.conflint")
    if conflint is not None:
        conflint._reported.clear()


def strict_config_enabled() -> bool:
    return _STRICT_CONFIG


#: keys LayerParam.set_param consumes, shared by every layer (the common
#: hyperparameters of the reference's ``src/layer/param.h``)
LAYER_PARAM_KEYS: Tuple[KeySpec, ...] = (
    K("init_sigma", "float", help="gaussian init stddev"),
    K("init_uniform", "float", help="uniform init bound (<=0 = xavier)"),
    K("init_bias", "float"),
    K("random_type", "enum",
      choices=("gaussian", "uniform", "xavier", "kaiming")),
    K("nhidden", "int", lo=1),
    K("nchannel", "int", lo=1),
    K("ngroup", "int", lo=1),
    K("kernel_size", "int", lo=1),
    K("kernel_height", "int", lo=1),
    K("kernel_width", "int", lo=1),
    K("stride", "int", lo=1),
    K("pad", "int", lo=0),
    K("pad_y", "int", lo=0),
    K("pad_x", "int", lo=0),
    K("no_bias", "int", lo=0, hi=1),
    K("silent", "int", lo=0, hi=1),
)


class ShapeError(ValueError):
    pass


class ChSegs:
    """The value of a ``ch_concat`` node kept as its branch segments
    (``concat_virtual = 1``): split passes it on, channelwise pools map
    over the segments and a conv takes it as a sum of convs over the
    weight's channel slices (``nnet.net.conv_over_segs``), so an
    inception module's concat is never written.  Any other consumer
    concatenates it once (:meth:`materialize`, cached); autograd sees
    the underlying ops."""

    __slots__ = ("segs", "_mat")

    def __init__(self, segs):
        self.segs = list(segs)
        self._mat = None

    @property
    def shape(self):
        n, _, h, w = self.segs[0].shape
        return (n, sum(s.shape[1] for s in self.segs), h, w)

    def materialize(self) -> torch.Tensor:
        if self._mat is None:
            self._mat = torch.cat(self.segs, dim=1)
        return self._mat


def materialize(x):
    """A node's tensor: a :class:`ChSegs` concatenated, else ``x``."""
    return x.materialize() if isinstance(x, ChSegs) else x


def as_mat(x) -> torch.Tensor:
    """The (batch, c*h*w) view of a node (reference Node::mat())."""
    x = materialize(x)
    return x.reshape(x.shape[0], -1)


#: characters a scope name does not keep (the JAX package's rule)
_SCOPE_BAD = re.compile(r"[^A-Za-z0-9_.\-]")


def conn_scope_name(index: int, conn) -> str:
    """Canonical per-connection scope string: ``"<NN>-<name-or-type>"``.

    This is the SHARED contract between the three sides of layer
    attribution (doc/monitor.md "Layer attribution"): the net builder
    stamps each connection's forward with ``jax.named_scope`` under this
    string, the analytic cost model keys per-layer flops/bytes by it,
    and ``monitor/attribution.py`` matches it against profiler-trace op
    metadata.  The base comes from the connection's ``param_key``
    (``Network._layer_key``'s name-or-type resolution), so a
    ``layer_profile`` row and a monitor record like ``"16-fc6/wmat"``
    name the same layer the same way — modulo scope sanitization, since
    ``jax.named_scope`` rejects characters configs allow.  A SHARED
    connection reuses its primary's base under its OWN index (it
    executes separately even though parameters alias).  The zero-padded
    connection index makes scopes pairwise non-substring (no two
    connections share an index), so substring matching inside
    transform-wrapped paths like ``transpose(jvp(03-conv))`` is
    unambiguous."""
    base = conn.param_key.split("-", 1)[1]
    return f"{index:02d}-" + _SCOPE_BAD.sub("_", base)


@dataclasses.dataclass
class LabelInfo:
    """Label fields by name, each ``(batch, width)`` (the JAX package's
    ``LabelInfo``); eval and serving forwards pass none.  ``mask``
    ``(batch,)`` zeroes the loss of a short tail batch's replica padding
    (``DataBatch.tail_mask_padd``)."""

    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mask: Optional[torch.Tensor] = None

    def get(self, name: str) -> torch.Tensor:
        if name not in self.fields:
            raise KeyError(f"label field {name!r} is not declared "
                           f"(have {sorted(self.fields)}); use "
                           "label_vec[a,b) = name")
        return self.fields[name]


@dataclasses.dataclass
class DecodeState:
    """KV-cache plumbing for incremental decode (serve/decode.py).

    * ``"prefill"`` — the forward runs a whole prompt row at the net's
      width; attention layers store their fresh ``(k, v)`` in
      ``caches[key]`` and otherwise compute the normal causal path.
    * ``"block"`` — ``W`` consecutive positions per row from
      ``positions`` (one decode step is ``W = 1``; speculative verify,
      chunked prefill): attention layers write their ``W`` fresh columns
      into ``caches[key]`` in place, the ``(write_rows, write_cols)``
      cells from query ``write_from``, and query ``w`` attends under
      ``arange(max_seqlen) <= positions + w``.  The engine builds the
      write's indices on the host, leaving out the columns past the
      cache end, so the write needs no device-side mask.

    ``caches`` maps an attention connection's engine-stamped key to
    ``{"k": (rows, heads, max_seqlen, head_dim), "v": ...}``, which may
    hold a narrower or wider dtype than the activations
    (``decode_kv_dtype``): layers cast on write.
    """

    mode: str                                  # "prefill" | "block"
    caches: Dict[str, Dict[str, torch.Tensor]]
    # (rows,) int64, block mode: the first position written
    positions: Optional[torch.Tensor] = None
    # (n,) int64 each, block mode: the cache cells written (row, column)
    # and the query each takes its (k, v) from
    write_rows: Optional[torch.Tensor] = None
    write_cols: Optional[torch.Tensor] = None
    write_from: Optional[torch.Tensor] = None
    max_seqlen: int = 0


@dataclasses.dataclass
class ForwardContext:
    """Per-call context threaded through the forward pass.  A training
    forward carries the labels and collects each loss layer's scalar in
    ``losses``, already times ``loss_scale`` = 1 / (batch_size *
    update_period), the reference's per-instance gradient scaling.
    ``rng`` draws a training forward's random masks (dropout, insanity);
    ``epoch`` is the update count, which anneals insanity's range.
    ``diagnostics`` collects the step's 0-d diagnostic tensors
    (pairtest layers' relative errors), keyed ``<layer>:<what>``;
    ``mesh`` is the trainer's mesh and ``seq_split`` says whether this
    rank holds a block of the positions."""

    train: bool
    opts: EngineOptions
    labels: Optional[LabelInfo] = None
    decode: Optional[DecodeState] = None
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    diagnostics: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    loss_scale: float = 1.0
    rng: Optional[torch.Generator] = None
    epoch: int = 0
    # the trainer's data mesh (parallel/mesh.Mesh) or None: batch-
    # coupled layers (batch_norm) reduce their statistics over its data
    # axis, so a rank's rows behave as the global batch
    mesh: Optional[object] = None
    # True when the rank holds its block of positions of every row (a
    # seq axis wider than 1 dividing the sequence): attention runs as a
    # ring over it, positional layers offset to the block, sequence
    # statistics sum over it
    seq_split: bool = False


def _normal(gen: torch.Generator, shape, sigma: float, dtype) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=torch.float32) * sigma).to(dtype)


@dataclasses.dataclass
class LayerParam:
    """Common layer hyperparameters (the JAX package's ``LayerParam``)."""

    num_hidden: int = 0
    init_sigma: float = 0.01
    init_uniform: float = -1.0
    init_bias: float = 0.0
    num_channel: int = 0
    random_type: int = 0  # 0 gaussian, 1 uniform/xavier, 2 kaiming
    num_group: int = 1
    kernel_height: int = 0
    kernel_width: int = 0
    stride: int = 1
    pad_y: int = 0
    pad_x: int = 0
    no_bias: int = 0
    silent: int = 0

    def set_param(self, name: str, val: str) -> bool:
        """Consume one config key; True when it is a common key."""
        if name == "init_sigma":
            self.init_sigma = float(val)
        elif name == "init_uniform":
            self.init_uniform = float(val)
        elif name == "init_bias":
            self.init_bias = float(val)
        elif name == "random_type":
            m = {"gaussian": 0, "uniform": 1, "xavier": 1, "kaiming": 2}
            if val not in m:
                raise ValueError(f"invalid random_type {val!r}")
            self.random_type = m[val]
        elif name == "nhidden":
            self.num_hidden = int(val)
        elif name == "nchannel":
            self.num_channel = int(val)
        elif name == "ngroup":
            self.num_group = int(val)
        elif name == "kernel_size":
            self.kernel_height = self.kernel_width = int(val)
        elif name == "kernel_height":
            self.kernel_height = int(val)
        elif name == "kernel_width":
            self.kernel_width = int(val)
        elif name == "stride":
            self.stride = int(val)
        elif name == "pad":
            self.pad_y = self.pad_x = int(val)
        elif name == "pad_y":
            self.pad_y = int(val)
        elif name == "pad_x":
            self.pad_x = int(val)
        elif name == "no_bias":
            self.no_bias = int(val)
        elif name == "silent":
            self.silent = int(val)
        else:
            return False
        return True

    def rand_init_weight(self, gen: torch.Generator, shape: Sequence[int],
                         in_num: int, out_num: int,
                         dtype=torch.float32) -> torch.Tensor:
        """Weight init after ``param.h RandInitWeight``, with the JAX
        package's kaiming rule: ``sqrt(2 / fan_in)`` (its deliberate
        divergence from the reference's fan-out scale).  Draws come from
        ``gen`` (Philox), so values differ from the JAX package's
        threefry init; the distributions are the same."""
        shape = tuple(shape)
        if self.random_type == 0:
            return _normal(gen, shape, self.init_sigma, dtype)
        if self.random_type == 1:
            a = float(np.sqrt(3.0 / (in_num + out_num)))
            if self.init_uniform > 0:
                a = self.init_uniform
            u = torch.rand(shape, generator=gen, device=gen.device,
                           dtype=torch.float32)
            return (u * (2 * a) - a).to(dtype)
        if self.random_type == 2:
            sigma = float(np.sqrt(2.0 / in_num)) if in_num > 0 else 0.01
            return _normal(gen, shape, sigma, dtype)
        raise ValueError(f"unsupported random_type {self.random_type}")


class Layer:
    """Base class: subclasses override :meth:`infer_shapes`,
    :meth:`init_params`, :meth:`forward` and optionally
    :meth:`set_param`."""

    type_names: Tuple[str, ...] = ()
    # loss layers (the self-loops at a net's heads)
    is_loss: bool = False
    # embedding-style layers read their input as integer ids: the net
    # then keeps that input in float32 instead of casting it to a
    # narrow compute dtype (bf16 holds integers exactly only to 256)
    takes_ids: bool = False
    # keys this class's set_param consumes beyond LAYER_PARAM_KEYS (the
    # declared-key registry, analysis/registry.py, reads them along the
    # MRO); keep them in step with the set_param branches
    extra_config_keys: Tuple[KeySpec, ...] = ()

    def __init__(self) -> None:
        self.param = LayerParam()
        self.name: str = ""

    def set_param(self, name: str, val: str) -> None:
        """Consume a config key; unknown keys are ignored (reference
        rule: global keys are broadcast to every layer) unless
        ``strict_config = 1`` routes them through the lint reporter as
        warnings (keys this layer type declares, or any subsystem does,
        stay silent)."""
        consumed = self.param.set_param(name, val)
        if not consumed and _STRICT_CONFIG:
            from ..analysis.conflint import report_ignored_layer_key
            report_ignored_layer_key(self, name, val)

    @classmethod
    def config_keys(cls) -> Tuple[KeySpec, ...]:
        """Every key this layer type accepts: the common LayerParam keys
        and each class's declared extras along the MRO."""
        out = list(LAYER_PARAM_KEYS)
        for klass in cls.__mro__:
            out.extend(klass.__dict__.get("extra_config_keys", ()))
        return tuple(out)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator, in_shapes: List[Shape4],
                    dtype=torch.float32) -> Params:
        return {}

    def init_buffers(self, in_shapes: List[Shape4],
                     device: torch.device) -> Params:
        """Non-learned state (moving statistics, a fixed table)."""
        return {}

    def forward(self, params: Params, inputs: List[torch.Tensor],
                ctx: ForwardContext) -> List[torch.Tensor]:
        raise NotImplementedError

    def forward_buffers(self, params: Params, buffers: Params,
                        inputs: List[torch.Tensor], ctx: ForwardContext
                        ) -> Tuple[List[torch.Tensor], Params]:
        """``(outputs, new buffers)``: the JAX package's ``forward``.  A
        layer without buffers passes them through."""
        return self.forward(params, inputs, ctx), buffers

    def check_n_inputs(self, inputs: Sequence, lo: int,
                       hi: Optional[int] = None) -> None:
        hi = lo if hi is None else hi
        if not lo <= len(inputs) <= hi:
            raise ShapeError(f"{self.type_names[0]} layer expects {lo}..{hi}"
                             f" inputs, got {len(inputs)}")

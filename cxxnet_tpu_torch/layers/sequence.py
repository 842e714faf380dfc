"""Sequence-model layers: embedding, layernorm, per-position linear,
multi-head attention (with the incremental-decode cache path) and the
LM softmax head — the JAX package's ``layers/sequence.py`` in PyTorch.

Layouts at the module boundaries are the JAX package's: activations
``(b, 1, s, d)``, token ids float ``(b, 1, 1, s)``, ``wqkv`` ``(3d, d)``,
the KV cache ``(slots, h, S, hd)``.

Kernel selection is configuration, read from the forward context's
engine options: ``flash_attn = 1`` routes attention through the
autograd Functions of :mod:`~cxxnet_tpu_torch.ops.flash_attention`
(the segmented one when the layer has segment ids) wherever
:func:`~cxxnet_tpu_torch.ops.flash_attention.attention_route` finds a
kernel for the call, and through :func:`ring.dense_attention` where the
JAX package runs it too (heads wider than 256, non-causal attention
with segment ids); ``pallas_ln = 1`` (or ``x``, which saves the input
for the backward) routes layernorm through
:class:`~cxxnet_tpu_torch.ops.layernorm.LayerNorm`; ``0`` selects the
plain torch path the JAX package runs off the TPU.

Sequence parallelism: when the trainer split every row's positions over
the ``seq`` mesh axis (``ctx.seq_split``), attention runs as ring
attention over it (:func:`ring.sharded_attention`), the embedding adds
its block's rows of ``wpos`` and ``softmax_seq`` counts a row's targets
over all its blocks; a sequence the axis does not divide stays whole on
every rank and attention falls back to dense attention, with the JAX
package's warning.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..analysis.schema import K
from ..monitor import log as mlog
from ..ops.flash_attention import (attention_route, dense_reason,
                                   flash_attention,
                                   flash_attention_segmented)
from ..ops.layernorm import layernorm
from ..parallel import mesh as meshlib, ring
from .base import ForwardContext, Layer, Shape4, _normal
from .loss import LossLayerBase


def _label_field(ctx: ForwardContext, name: str) -> Optional[torch.Tensor]:
    """A (b, s) label field by name, or None when unset or absent (eval
    and serving forwards carry no labels)."""
    if not name or ctx.labels is None or name not in ctx.labels.fields:
        return None
    return ctx.labels.fields[name]


def single_device_attention(q, k, v, causal: bool, ctx: ForwardContext,
                            seg: Optional[torch.Tensor] = None):
    """(b, h, s, hd) attention.  Under ``flash_attn = 1``, as
    :func:`attention_route` decides from the shapes before any launch:
    the segmented flash Function when there are segment ids (causal), the
    plain flash Function without, and :func:`ring.dense_attention` where
    the JAX package takes it (counted in ``dense_routes``; the first of a
    count logs its reason).  Under ``flash_attn = 0`` always
    :func:`ring.dense_attention`."""
    b, h, s, hd = q.shape
    if ctx.opts.flash_attn != "1":
        return ring.dense_attention(q, k, v, causal=causal, seg=seg)
    route = attention_route(hd, causal, seg is not None)
    if route == "dense":
        single_device_attention.dense_routes += 1
        if single_device_attention.dense_routes == 1:
            mlog.notice("attention: plain dense attention for "
                        + dense_reason(hd, causal, seg is not None))
        return ring.dense_attention(q, k, v, causal=causal, seg=seg)
    q3, k3, v3 = (t.reshape(b * h, s, hd).contiguous() for t in (q, k, v))
    if route == "flash":
        o = flash_attention(q3, k3, v3, causal)
    else:
        o = flash_attention_segmented(q3, k3, v3, seg)
    return o.reshape(b, h, s, hd)


#: calls under ``flash_attn = 1`` that took dense attention
single_device_attention.dense_routes = 0


def _seq_unsplit(ctx: ForwardContext) -> bool:
    """True on a mesh whose ``seq`` axis is wider than 1 but does not
    split this forward's positions (the sequence does not divide it):
    every rank of the axis holds the whole sequence."""
    mesh = ctx.mesh
    return (mesh is not None and not mesh.virtual and not ctx.seq_split
            and mesh.axis_size("seq") > 1)


class EmbeddingLayer(Layer):
    """Token embedding: (b,1,1,s) float ids -> (b,1,s,d); ``wmat``
    (vocab, d), and with ``pos_embed = 1`` ``wpos`` (s, d)."""

    type_names = ("embedding",)
    takes_ids = True
    extra_config_keys = (
        K("vocab_size", "int", lo=1),
        K("pos_embed", "int", lo=0, hi=1),
        K("pos_key", "str",
          help="label field carrying per-position ids (packed documents "
               "reset positions at each doc start — io/text.py); empty = "
               "sequential 0..s-1"),
    )

    def __init__(self):
        super().__init__()
        self.vocab_size = 0
        self.pos_embed = 0
        self.pos_key = ""

    def set_param(self, name, val):
        if name == "vocab_size":
            self.vocab_size = int(val)
        elif name == "pos_embed":
            self.pos_embed = int(val)
        elif name == "pos_key":
            self.pos_key = val
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "embedding: 1-1 connection only"
        n, c, h, s = in_shapes[0]
        assert c == 1 and h == 1, "embedding: input must be (b,1,1,seq) ids"
        assert self.vocab_size > 0, "embedding: must set vocab_size"
        assert self.param.num_hidden > 0, "embedding: must set nhidden"
        return [(n, 1, s, self.param.num_hidden)]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        d = self.param.num_hidden
        sigma = self.param.init_sigma
        params = {"wmat": _normal(gen, (self.vocab_size, d), sigma, dtype)}
        if self.pos_embed:
            params["wpos"] = _normal(gen, (in_shapes[0][3], d), sigma, dtype)
        return params

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        ids = inputs[0].reshape(inputs[0].shape[0], -1).long()
        out = params["wmat"][ids]  # (b, s, d)
        if "wpos" in params:
            wpos = params["wpos"]
            dec = ctx.decode
            pos = _label_field(ctx, self.pos_key)
            if dec is not None and dec.mode == "block":
                # incremental decode: each row sits at its own W
                # consecutive positions
                pidx = (dec.positions[:, None]
                        + torch.arange(ids.shape[1], device=ids.device)
                        [None, :]).clamp(0, wpos.shape[0] - 1)
                out = out + wpos[pidx].to(out.dtype)
            elif pos is not None:
                # packed documents: per (b, s) position ids
                pidx = pos.long().clamp(0, wpos.shape[0] - 1)
                out = out + wpos[pidx].to(out.dtype)
            else:
                # sequential positions; a rank holding a block of the
                # positions adds the block's rows of the table
                s = ids.shape[1]
                off = ctx.mesh.axis_index("seq") * s if ctx.seq_split \
                    else 0
                out = out + wpos[None, off:off + s, :].to(out.dtype)
        return [out[:, None, :, :]]


class LayerNormLayer(Layer):
    """LayerNorm over the last axis of (b,1,s,d); slope/shift under the
    ``wmat`` / ``bias`` tags."""

    type_names = ("layernorm",)
    extra_config_keys = (K("eps", "float", lo=0.0),)

    def __init__(self):
        super().__init__()
        self.eps = 1e-5

    def set_param(self, name, val):
        if name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "layernorm: 1-1 connection only"
        return [in_shapes[0]]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        d = in_shapes[0][3]
        dev = gen.device
        return {"wmat": torch.ones((d,), dtype=dtype, device=dev),
                "bias": torch.zeros((d,), dtype=dtype, device=dev)}

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        d = x.shape[-1]
        if ctx.opts.pallas_ln in ("1", "x"):
            y = layernorm(x.reshape(-1, d).contiguous(), params["wmat"],
                          params["bias"], self.eps, ctx.opts.pallas_ln == "x")
            return [y.reshape(x.shape)]
        # the plain path, as the JAX package lowers it off the TPU
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        if x.dtype == torch.bfloat16:
            # single-pass moments, as the JAX package does for bf16
            m2 = torch.square(x32).mean(dim=-1, keepdim=True)
            var = torch.clamp(m2 - torch.square(mean), min=0.0)
        else:
            var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * params["wmat"].float() + params["bias"].float()
        return [y.to(x.dtype)]


class SeqFullcLayer(Layer):
    """Per-position linear: (b,1,s,d) -> (b,1,s,nhidden); ``wmat``
    (nhidden, d), ``bias`` (nhidden,)."""

    type_names = ("seq_fullc",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "seq_fullc: 1-1 connection only"
        n, c, s, d = in_shapes[0]
        assert c == 1, "seq_fullc: input must be (b,1,s,d)"
        assert self.param.num_hidden > 0, "seq_fullc: must set nhidden"
        return [(n, 1, s, self.param.num_hidden)]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        d = in_shapes[0][3]
        nh = self.param.num_hidden
        params = {"wmat": self.param.rand_init_weight(gen, (nh, d), d, nh,
                                                      dtype)}
        if not self.param.no_bias:
            params["bias"] = torch.full((nh,), self.param.init_bias,
                                        dtype=dtype, device=gen.device)
        return params

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        b = params.get("bias")
        return [F.linear(x, params["wmat"].to(x.dtype),
                         None if b is None else b.to(x.dtype))]


class AttentionLayer(Layer):
    """Multi-head self-attention on (b,1,s,d): ``wqkv`` (3d, d), ``wout``
    (d, d), biases ``bqkv`` / ``bout`` unless ``no_bias``; config
    ``nhead`` (required), ``causal``, ``segment_key``."""

    type_names = ("attention",)
    extra_config_keys = (
        K("nhead", "int", lo=1), K("causal", "int", lo=0, hi=1),
        K("segment_key", "str",
          help="label field with per-position segment ids (packed "
               "documents, io/text.py): attention is block-diagonal — "
               "cross-segment scores masked, segment 0 = padding"),
    )

    def __init__(self):
        super().__init__()
        self.nhead = 0
        self.causal = 0
        self.segment_key = ""
        self.decode_key: Optional[str] = None  # stamped by DecodeEngine

    def set_param(self, name, val):
        if name == "nhead":
            self.nhead = int(val)
        elif name == "causal":
            self.causal = int(val)
        elif name == "segment_key":
            self.segment_key = val
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "attention: 1-1 connection only"
        n, c, s, d = in_shapes[0]
        assert c == 1, "attention: input must be (b,1,s,d)"
        assert self.nhead > 0, "attention: must set nhead"
        assert d % self.nhead == 0, "attention: nhead must divide dim"
        return [in_shapes[0]]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        d = in_shapes[0][3]
        p = self.param
        params = {"wqkv": p.rand_init_weight(gen, (3 * d, d), d, 3 * d, dtype),
                  "wout": p.rand_init_weight(gen, (d, d), d, d, dtype)}
        if not p.no_bias:
            params["bqkv"] = torch.zeros((3 * d,), dtype=dtype,
                                         device=gen.device)
            params["bout"] = torch.zeros((d,), dtype=dtype, device=gen.device)
        return params

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        b, _, s, d = x.shape
        h = self.nhead
        hd = d // h
        bqkv = params.get("bqkv")
        qkv = F.linear(x, params["wqkv"].to(x.dtype),
                       None if bqkv is None else bqkv.to(x.dtype))
        qkv = qkv.reshape(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (b, h, s, hd)
        if ctx.decode is not None:
            att = self._decode_attention(ctx, q, k, v)
        else:
            seg = _label_field(ctx, self.segment_key)
            if seg is not None:
                seg = seg.long()
            if ctx.seq_split:
                att = ring.sharded_attention(q, k, v, ctx.mesh,
                                             causal=bool(self.causal),
                                             seg=seg)
            else:
                if _seq_unsplit(ctx):
                    warnings.warn(
                        f"attention: seq length {s} is not divisible by the "
                        f"seq mesh axis ({ctx.mesh.axis_size('seq')}); "
                        "falling back to dense attention, which gathers the "
                        "full sequence on one device", stacklevel=2)
                att = single_device_attention(q, k, v, bool(self.causal),
                                              ctx, seg=seg)
        att = att.transpose(1, 2).reshape(b, 1, s, d)
        bout = params.get("bout")
        return [F.linear(att, params["wout"].to(x.dtype),
                         None if bout is None else bout.to(x.dtype))]

    def _decode_attention(self, ctx, q, k, v):
        """Cache-aware attention for incremental decode.

        Prefill stores this layer's fresh ``(k, v)`` in the decode state
        and runs the normal causal path.  Block mode (``W`` consecutive
        positions per row; a decode step is ``W = 1``) writes the fresh
        columns into the cache in place at the engine's host-built
        ``(write_rows, write_cols)`` (columns past the cache end are left
        out, as the JAX package's ``mode="drop"`` scatter drops them) and
        query ``w`` attends over the whole cache under the length mask
        ``arange(S) <= positions + w``: masked scores get ``NEG_INF`` and
        softmax to exactly 0, so never-written cache columns are
        invisible.  The cache is cast to on write and read back in the
        activations' dtype; scores and ``p·V`` run in float32, as the JAX
        package's ``preferred_element_type`` does."""
        dec = ctx.decode
        key = self.decode_key
        assert key is not None, \
            "attention: decode forward without an engine-stamped cache key"
        assert self.causal, "incremental decode requires causal = 1"
        if dec.mode == "prefill":
            dec.caches[key] = {"k": k, "v": v}
            return single_device_attention(q, k, v, True, ctx)
        assert dec.mode == "block", f"unknown decode mode {dec.mode}"
        b, h, s, hd = q.shape
        cache = dec.caches[key]
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[2]
        r, c, w = dec.write_rows, dec.write_cols, dec.write_from
        ck[r, :, c] = k.transpose(1, 2)[r, w].to(ck.dtype)
        cv[r, :, c] = v.transpose(1, 2)[r, w].to(cv.dtype)
        scale = 1.0 / (hd ** 0.5)
        scores = torch.matmul(q.float(),
                              ck.to(q.dtype).float().transpose(-1, -2)) \
            * scale
        # query w of a row sees the columns <= positions + w
        last = dec.positions[:, None] + torch.arange(s, device=q.device)
        mask = torch.arange(S, device=q.device)[None, None, :] \
            <= last[:, :, None]
        scores = torch.where(mask[:, None, :, :], scores, ring.NEG_INF)
        p = torch.softmax(scores, dim=-1)
        return torch.matmul(p, cv.float()).to(q.dtype)


class SoftmaxSeqLayer(LossLayerBase):
    """Per-position softmax over the vocabulary plus, in a training
    forward, the mean per-token cross-entropy of the ``target`` label
    field (``(b, s)`` token ids) as the loss.

    ``packed = 1`` (document-packed rows, io/text.py): target ids < 0
    mark positions whose next token crosses a document boundary or is
    padding; they contribute zero loss and zero gradient, and a row's
    mean divides by its count of valid targets (at least 1)."""

    type_names = ("softmax_seq",)
    extra_config_keys = (
        K("packed", "int", lo=0, hi=1,
          help="mask target ids < 0 (packed-document boundaries/padding) "
               "out of the loss; mean over valid tokens only"),
    )

    def __init__(self):
        super().__init__()
        self.packed = 0

    def set_param(self, name, val):
        if name == "packed":
            self.packed = int(val)
        else:
            super().set_param(name, val)

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]  # (b, 1, s, V)
        if not (ctx.train and ctx.labels is not None):
            return [torch.softmax(x, dim=-1)]
        y = ctx.labels.get(self.target)  # (b, s) float ids
        logp = torch.log_softmax(x[:, 0].float(), dim=-1)
        yi = y.long()
        if self.packed:
            valid = (y >= 0).float()
            tok = logp.gather(2, yi.clamp(min=0)[:, :, None])[:, :, 0]
            count = valid.sum(dim=1)
            if ctx.seq_split:
                # a row's valid targets over all its blocks
                count = meshlib.all_reduce(count, ctx.mesh, "seq")
            per_inst = -(tok * valid).sum(dim=1) / count.clamp(min=1.0)
        else:
            tok = logp.gather(2, yi[:, :, None])[:, :, 0]
            if ctx.seq_split:
                # this block's share of the row's mean
                per_inst = -tok.sum(dim=1) / (
                    tok.shape[1] * ctx.mesh.axis_size("seq"))
            else:
                per_inst = -tok.mean(dim=1)
        self.add_loss(ctx, per_inst)
        # the output node is not part of the loss: no autograd graph
        with torch.no_grad():
            return [torch.softmax(x, dim=-1)]

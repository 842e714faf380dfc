"""``batch_norm`` and ``dropout`` (the JAX package's ``layers/norm.py``;
reference ``batch_norm_layer-inl.hpp``, ``dropout_layer-inl.hpp``).

The dropout mask comes from the trainer's ``torch.Generator`` on its
device (``ForwardContext.rng``), so it differs from the JAX package's
threefry bits; the distribution is the same.
"""

from __future__ import annotations

from typing import List

import torch

from ..analysis.schema import K
from ..ops import nn as N
from ..parallel.data import data_size, global_sum
from .base import Layer, Shape4


class BatchNormLayer(Layer):
    """Batch normalisation a channel (a conv node) or a feature (a flat
    (n, 1, 1, d) node), in float32: slope ``wmat``, bias ``bias``.  As
    the reference does, eval normalises by the batch's own statistics
    too (``moving_average = 0``, the default); every training forward
    also updates the ``moving_mean`` / ``moving_var`` buffers (momentum
    ``bn_momentum``), which ``moving_average = 1`` reads at eval.  A
    short tail batch's replica padding (``ctx.labels.mask``) is left out
    of the batch statistics.  On a data mesh the statistics are the
    global batch's (:meth:`_global_moments`)."""

    type_names = ("batch_norm",)
    extra_config_keys = (
        K("init_slope", "float"), K("eps", "float", lo=0.0),
        K("moving_average", "int", lo=0, hi=1),
        K("bn_momentum", "float", lo=0.0, hi=1.0),
    )

    def __init__(self):
        super().__init__()
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10
        self.moving_average = 0
        self.bn_momentum = 0.9

    def set_param(self, name, val):
        if name in ("init_slope", "init_bias", "eps", "bn_momentum"):
            setattr(self, name, float(val))
        elif name == "moving_average":
            self.moving_average = int(val)
        else:
            super().set_param(name, val)

    @staticmethod
    def _channel_axis(shape) -> int:
        return 3 if shape[1] == 1 else 1

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "batch_norm: 1-1 connection only"
        return [in_shapes[0]]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        c = in_shapes[0][self._channel_axis(in_shapes[0])]
        return {t: torch.full((c,), v, dtype=dtype, device=gen.device)
                for t, v in (("wmat", self.init_slope),
                             ("bias", self.init_bias))}

    def init_buffers(self, in_shapes, device):
        c = in_shapes[0][self._channel_axis(in_shapes[0])]
        return {"moving_mean": torch.zeros(c, device=device),
                "moving_var": torch.ones(c, device=device)}

    def forward_buffers(self, params, buffers, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        ax = self._channel_axis(x.shape)
        dims = tuple(i for i in range(4) if i != ax)
        bshape = [1, 1, 1, 1]
        bshape[ax] = x.shape[ax]
        xf = x.float()
        mask = ctx.labels.mask if (ctx.train and ctx.labels is not None) \
            else None
        if (ctx.train or not self.moving_average) \
                and data_size(ctx.mesh) > 1:
            mean, var = self._global_moments(xf, mask, dims, bshape, ax,
                                             ctx.mesh)
        elif ctx.train or not self.moving_average:
            if mask is not None:
                m4 = mask.float().reshape(-1, 1, 1, 1)
                denom = torch.clamp(
                    m4.sum() * (xf.numel() / xf.shape[0] / xf.shape[ax]),
                    min=1.0)
                mean = (xf * m4).sum(dims) / denom
                var = (torch.square(xf - mean.reshape(bshape)) * m4
                       ).sum(dims) / denom
            else:
                mean = xf.mean(dims)
                var = torch.square(xf - mean.reshape(bshape)).mean(dims)
        else:
            mean, var = buffers["moving_mean"], buffers["moving_var"]
        inv = torch.rsqrt(var + self.eps)
        out = (xf - mean.reshape(bshape)) * inv.reshape(bshape)
        out = (out * params["wmat"].float().reshape(bshape)
               + params["bias"].float().reshape(bshape))
        if ctx.train:
            m = self.bn_momentum
            buffers = {"moving_mean": m * buffers["moving_mean"]
                       + (1 - m) * mean.detach(),
                       "moving_var": m * buffers["moving_var"]
                       + (1 - m) * var.detach()}
        return [out.to(x.dtype)], buffers


    @staticmethod
    def _global_moments(xf, mask, dims, bshape, ax, mesh):
        """The mean and (two-pass) variance of the GLOBAL batch from a
        rank's rows on a data mesh (the JAX package's statistics over the
        sharded batch): each partial sum, and the count, summed over
        ``data`` (:func:`~..parallel.data.global_sum`, whose backward
        sums the cotangents over ``data`` in turn).  Padded tail rows
        (``mask``) count nowhere, on whichever rank they fall.  Every
        rank gets the same statistics, so the moving buffers stay equal."""
        per_row = xf.numel() / xf.shape[0] / xf.shape[ax]
        if mask is not None:
            m4 = mask.float().reshape(-1, 1, 1, 1)
            count = global_sum(m4.sum() * per_row, mesh)
            denom = torch.clamp(count, min=1.0)
            mean = global_sum((xf * m4).sum(dims), mesh) / denom
            var = global_sum((torch.square(xf - mean.reshape(bshape))
                              * m4).sum(dims), mesh) / denom
        else:
            denom = per_row * xf.shape[0] * data_size(mesh)
            mean = global_sum(xf.sum(dims), mesh) / denom
            var = global_sum(torch.square(xf - mean.reshape(bshape))
                             .sum(dims), mesh) / denom
        return mean, var


class DropoutLayer(Layer):
    """Self-loop dropout: ``x * threshold(uniform, pkeep) / pkeep`` in a
    training forward, identity otherwise."""

    type_names = ("dropout",)
    extra_config_keys = (
        K("threshold", "float", lo=0.0, hi=0.999,
          help="drop probability (1 - pkeep)"),
    )

    def __init__(self):
        super().__init__()
        self.threshold = 0.0

    def set_param(self, name, val):
        if name == "threshold":
            self.threshold = float(val)
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "dropout: 1-1 connection only"
        assert 0.0 <= self.threshold < 1.0, "dropout: invalid threshold"
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        if not ctx.train or self.threshold == 0.0:
            return [x]
        mask = N.batch_draw(N.dropout_mask, ctx, x.shape,
                            1.0 - self.threshold, x.dtype)
        return [x * mask]

"""Activation layers: ``relu``, ``sigmoid``, ``tanh``, ``softplus``,
``gelu``, ``xelu``, ``insanity``, ``prelu`` and ``bias`` (the JAX
package's ``layers/activation.py``; reference ``activation_layer-inl.hpp``
+ ``op.h``, ``xelu_layer``, ``insanity_layer``, ``prelu_layer``,
``bias_layer``).

relu's gradient is masked by its output, as the reference's ``relu_grad``
and the JAX package's default ``relu_vjp = out`` compute it (torch's
relu backward reads its output too); ``relu_vjp = xla`` is ``max(x,
0)`` (``ops.nn.relu``).  ``jax.nn.gelu`` defaults to the tanh
approximation, which the port matches with ``approximate="tanh"``.
Insanity's divisors and prelu's noise come from the trainer's
``torch.Generator`` (``ops.nn.uniform``), not the JAX package's threefry
bits; the distributions are the same.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..analysis.schema import K
from ..ops import nn as N
from .base import Layer, Shape4


class _UnaryLayer(Layer):
    """1-in 1-out elementwise layer, shape-preserving."""

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, \
            f"{self.type_names[0]}: 1-1 connection only"
        return [in_shapes[0]]

    def _fn(self, x: torch.Tensor, ctx) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        return [self._fn(inputs[0], ctx)]


class ReluLayer(_UnaryLayer):
    type_names = ("relu",)

    def __init__(self):
        super().__init__()
        # set by the trainer's relu -> max_pool reorder: this layer
        # passes its input through and the pool applies the relu to the
        # (stride^2-smaller) pooled tensor
        self.defer_to_pool = False

    def _fn(self, x, ctx):
        return x if self.defer_to_pool else N.relu(x, ctx.opts)


class SigmoidLayer(_UnaryLayer):
    type_names = ("sigmoid",)

    def _fn(self, x, ctx):
        return torch.sigmoid(x)


class TanhLayer(_UnaryLayer):
    type_names = ("tanh",)

    def _fn(self, x, ctx):
        return torch.tanh(x)


class SoftplusLayer(_UnaryLayer):
    type_names = ("softplus",)

    def _fn(self, x, ctx):
        return F.softplus(x)


class GeluLayer(_UnaryLayer):
    type_names = ("gelu",)

    def _fn(self, x, ctx):
        return F.gelu(x, approximate="tanh")


class XeluLayer(_UnaryLayer):
    """Leaky relu with divisor b: x > 0 ? x : x / b (op.h:51-61;
    default b = 5)."""

    type_names = ("xelu",)
    extra_config_keys = (K("b", "float", help="leak divisor"),)

    def __init__(self):
        super().__init__()
        self.b = 5.0

    def set_param(self, name, val):
        if name == "b":
            self.b = float(val)
        else:
            super().set_param(name, val)

    def _fn(self, x, ctx):
        return torch.where(x > 0, x, x / self.b)


class InsanityLayer(_UnaryLayer):
    """Randomised leaky relu (insanity_layer-inl.hpp:13-102): training
    divides each negative element by a uniform draw in [lb, ub], eval by
    the mean (lb + ub) / 2.  Between steps ``calm_start`` and
    ``calm_end`` the range narrows linearly to its midpoint, in closed
    form of the update count (``ctx.epoch``)."""

    type_names = ("insanity",)
    extra_config_keys = (
        K("lb", "float"), K("ub", "float"),
        K("calm_start", "int", lo=0), K("calm_end", "int", lo=0),
    )

    def __init__(self):
        super().__init__()
        self.lb, self.ub = 5.0, 10.0
        self.calm_start = self.calm_end = 0

    def set_param(self, name, val):
        if name in ("lb", "ub"):
            setattr(self, name, float(val))
        elif name in ("calm_start", "calm_end"):
            setattr(self, name, int(val))
        else:
            super().set_param(name, val)

    def _bounds(self, step: int):
        if self.calm_end <= self.calm_start:
            return self.lb, self.ub
        mid = (self.lb + self.ub) / 2.0
        delta = (self.ub - mid) / (self.calm_end - self.calm_start)
        t = min(max(step - self.calm_start, 0),
                self.calm_end - self.calm_start)
        return self.lb + delta * t, self.ub - delta * t

    def _fn(self, x, ctx):
        if ctx.train:
            lb, ub = self._bounds(int(ctx.epoch))
            divisor = (N.batch_draw(N.uniform, ctx, x.shape, x.dtype)
                       * (ub - lb) + lb)
            return torch.where(x > 0, x, x / divisor)
        return torch.where(x > 0, x, x / ((self.lb + self.ub) / 2.0))


def _feature_axis(shape) -> int:
    """The channel axis of a node: the last of a flat (n, 1, 1, d) node,
    else 1."""
    return 3 if shape[1] == 1 else 1


class PReluLayer(_UnaryLayer):
    """Learnable slope a channel (prelu_layer-inl.hpp:47-173): x > 0 ? x
    : x * clip(slope * noise, 0, 1), the noise uniform in [1 - random, 1
    + random] in a training forward.  The slope is the ``bias`` tag, as
    the reference's visitor names it."""

    type_names = ("prelu",)
    extra_config_keys = (
        K("init_slope", "float"), K("random_slope", "int", lo=0, hi=1),
        K("random", "float"),
    )

    def __init__(self):
        super().__init__()
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0

    def set_param(self, name, val):
        if name == "init_slope":
            self.init_slope = float(val)
        elif name == "random_slope":
            self.init_random = int(val)
        elif name == "random":
            self.random = float(val)
        else:
            super().set_param(name, val)

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        c = in_shapes[0][_feature_axis(in_shapes[0])]
        if self.init_random:
            slope = N.uniform(gen, (c,), dtype) * self.init_slope
        else:
            slope = torch.full((c,), self.init_slope, dtype=dtype,
                               device=gen.device)
        return {"bias": slope}

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        shape = [1, 1, 1, 1]
        ax = _feature_axis(x.shape)
        shape[ax] = x.shape[ax]
        mask = params["bias"].reshape(shape)
        if ctx.train and self.random > 0:
            u = N.batch_draw(N.uniform, ctx, x.shape, x.dtype)
            mask = mask * (1 + u * self.random * 2.0 - self.random)
        mask = torch.clamp(mask, 0.0, 1.0)
        return [torch.where(x > 0, x, x * mask)]


class BiasLayer(_UnaryLayer):
    """Self-loop bias a feature of a flat node (bias_layer-inl.hpp)."""

    type_names = ("bias",)

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        n, c, h, w = in_shapes[0]
        assert c == 1 and h == 1, "bias layer expects a flat (n,1,1,d) node"
        return {"bias": torch.full((w,), self.param.init_bias, dtype=dtype,
                                   device=gen.device)}

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        return [x + params["bias"].to(x.dtype).reshape(1, 1, 1, -1)]

"""Activation layers: ``relu``, ``sigmoid``, ``tanh``, ``softplus`` and
``gelu`` (the JAX package's ``layers/activation.py``; reference
``activation_layer-inl.hpp`` + ``op.h``).  ``xelu``, ``prelu``,
``insanity`` and ``bias`` are not ported (ROADMAP.md).

relu's gradient is masked by its output, as the reference's ``relu_grad``
and the JAX package's default ``relu_vjp = out`` compute it (torch's
relu backward reads its output too).  ``jax.nn.gelu`` defaults to the
tanh approximation, which the port matches with ``approximate="tanh"``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .base import Layer, Shape4


class _UnaryLayer(Layer):
    """1-in 1-out elementwise layer, shape-preserving."""

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, \
            f"{self.type_names[0]}: 1-1 connection only"
        return [in_shapes[0]]

    def _fn(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        return [self._fn(inputs[0])]


class ReluLayer(_UnaryLayer):
    type_names = ("relu",)

    def __init__(self):
        super().__init__()
        # set by the trainer's relu -> max_pool reorder: this layer
        # passes its input through and the pool applies the relu to the
        # (stride^2-smaller) pooled tensor
        self.defer_to_pool = False

    def _fn(self, x):
        return x if self.defer_to_pool else torch.relu(x)


class SigmoidLayer(_UnaryLayer):
    type_names = ("sigmoid",)

    def _fn(self, x):
        return torch.sigmoid(x)


class TanhLayer(_UnaryLayer):
    type_names = ("tanh",)

    def _fn(self, x):
        return torch.tanh(x)


class SoftplusLayer(_UnaryLayer):
    type_names = ("softplus",)

    def _fn(self, x):
        return F.softplus(x)


class GeluLayer(_UnaryLayer):
    type_names = ("gelu",)

    def _fn(self, x):
        return F.gelu(x, approximate="tanh")

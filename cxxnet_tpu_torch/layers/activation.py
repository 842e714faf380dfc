"""Activations on this slice's path: ``gelu``.

``jax.nn.gelu`` defaults to the tanh approximation, which is what the
JAX package's gelu layer computes; the port matches it with
``approximate="tanh"`` (torch's default is the exact erf form).
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from .base import Layer, Shape4


class GeluLayer(Layer):
    type_names = ("gelu",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "gelu: 1-1 connection only"
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        return [F.gelu(inputs[0], approximate="tanh")]

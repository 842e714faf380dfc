"""``dropout`` (the JAX package's ``layers/norm.py``; reference
``dropout_layer-inl.hpp``).  ``batch_norm`` is not ported (ROADMAP.md).

The mask comes from the trainer's ``torch.Generator`` on its device
(``ForwardContext.rng``), so it differs from the JAX package's threefry
bits; the distribution is the same.
"""

from __future__ import annotations

from typing import List

from ..ops import nn as N
from .base import Layer, Shape4


class DropoutLayer(Layer):
    """Self-loop dropout: ``x * threshold(uniform, pkeep) / pkeep`` in a
    training forward, identity otherwise."""

    type_names = ("dropout",)

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
        mask = N.dropout_mask(ctx.rng, x.shape, 1.0 - self.threshold,
                              x.dtype)
        return [x * mask]

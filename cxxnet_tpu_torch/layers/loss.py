"""Loss-layer base: the self-loop that marks a net's head.

On this slice the loss layers only matter as markers — the decode
engine stops its forward before the first one and reads the raw logits
from its input node — and as the softmax transform of an eval forward.
The training loss terms come with the training slice.
"""

from __future__ import annotations

from typing import List

from .base import Layer, Shape4


class LossLayerBase(Layer):
    is_loss = True

    def __init__(self):
        super().__init__()
        self.target = "label"
        self.grad_scale = 1.0

    def set_param(self, name, val):
        if name == "target":
            self.target = val
        elif name == "grad_scale":
            self.grad_scale = float(val)
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "loss layer: self-loop connection only"
        return [in_shapes[0]]

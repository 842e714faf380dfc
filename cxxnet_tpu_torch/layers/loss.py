"""Loss-layer base: the self-loop that marks a net's head (the JAX
package's ``layers/loss.py`` ``LossLayerBase``).

A loss layer's forward applies its output transform and, in a training
forward, appends one scalar to ``ctx.losses``: the sum over instances of
the per-instance loss, times ``grad_scale * ctx.loss_scale`` with
``loss_scale = 1 / (batch_size * update_period)``, so that autograd of
the summed losses reproduces the reference's hand-set gradient scaling
(loss_layer_base-inl.hpp:59-62).  A short tail batch's replica padding
(``ctx.labels.mask``) contributes zero loss and zero gradient.  The
decode engine stops its forward before the first loss layer and reads
the raw logits from its input node.
"""

from __future__ import annotations

from typing import List

import torch

from .base import ForwardContext, Layer, Shape4


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

    def add_loss(self, ctx: ForwardContext, per_inst: torch.Tensor) -> None:
        """Append this layer's scaled loss term for the ``(batch,)``
        per-instance losses ``per_inst``."""
        if ctx.labels.mask is not None:
            per_inst = per_inst * ctx.labels.mask.to(per_inst.dtype)
        ctx.losses.append(per_inst.sum()
                          * (self.grad_scale * ctx.loss_scale))

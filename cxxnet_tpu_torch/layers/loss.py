"""Loss layers: the base of the self-loop that marks a net's head, and
``softmax``, ``l2_loss`` and ``multi_logistic`` (the JAX package's
``layers/loss.py``; reference ``src/layer/loss/*``).

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
import torch.nn.functional as F

from ..analysis.schema import K
from .base import ForwardContext, Layer, Shape4


class LossLayerBase(Layer):
    is_loss = True
    extra_config_keys = (
        K("target", "str", help="label field this loss consumes"),
        K("grad_scale", "float"),
    )

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


class _FlatLossLayer(LossLayerBase):
    """A loss over the (batch, k) view of its node: the output is
    ``_transform`` of it, and a training forward adds the per-instance
    loss of the ``target`` label field.  The output is not part of the
    loss, so it carries no autograd graph."""

    def _transform(self, x2d: torch.Tensor) -> torch.Tensor:
        return x2d

    def _per_instance_loss(self, x2d: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        x2d = x.reshape(x.shape[0], -1)
        if ctx.train and ctx.labels is not None:
            self.add_loss(ctx, self._per_instance_loss(
                x2d, ctx.labels.get(self.target)))
        with torch.no_grad():
            return [self._transform(x2d).reshape(x.shape)]


class SoftmaxLayer(_FlatLossLayer):
    """Softmax + cross-entropy on integer class labels (reference
    softmax_layer-inl.hpp: gradient p with p[y] -= 1)."""

    type_names = ("softmax",)

    def _transform(self, x2d):
        return torch.softmax(x2d, dim=-1)

    def _per_instance_loss(self, x2d, labels):
        logp = torch.log_softmax(x2d.float(), dim=-1)
        return -logp.gather(1, labels[:, :1].long())[:, 0]


class L2LossLayer(_FlatLossLayer):
    """Identity + squared error, gradient p - y (l2_loss_layer-inl.hpp)."""

    type_names = ("l2_loss",)

    def _per_instance_loss(self, x2d, labels):
        return 0.5 * torch.square(x2d.float() - labels.float()).sum(dim=1)


class MultiLogisticLayer(_FlatLossLayer):
    """Elementwise sigmoid + binary cross-entropy, gradient sigmoid(x) - y
    (multi_logistic_layer-inl.hpp)."""

    type_names = ("multi_logistic",)

    def _transform(self, x2d):
        return torch.sigmoid(x2d)

    def _per_instance_loss(self, x2d, labels):
        return F.binary_cross_entropy_with_logits(
            x2d.float(), labels.float(), reduction="none").sum(dim=1)

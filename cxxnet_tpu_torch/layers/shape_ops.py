"""Graph plumbing layers: ``flatten`` ((n, c, h, w) -> (n, 1, 1,
c*h*w)), ``split`` (1 -> N copies), ``concat`` / ``ch_concat`` (2-4
nodes joined on the flat-feature or the channel axis;
concat_layer-inl.hpp), ``maxout`` (the max over groups of channels) and
``eltsum`` (elementwise sum of same-shape nodes, the residual join)."""

from __future__ import annotations

from typing import List

import torch

from .base import Layer, Shape4


class FlattenLayer(Layer):
    type_names = ("flatten",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "flatten: 1-1 connection only"
        n, c, h, w = in_shapes[0]
        return [(n, 1, 1, c * h * w)]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        return [x.reshape(x.shape[0], 1, 1, -1)]


class SplitLayer(Layer):
    type_names = ("split",)

    def __init__(self):
        super().__init__()
        self.num_out = 2  # set by the graph wiring

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "split: single input only"
        return [in_shapes[0]] * self.num_out

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        return [inputs[0]] * self.num_out


class ConcatLayer(Layer):
    """2-4 nodes -> 1, joined on the flat-feature axis (dim 3; the
    reference caps a concat at 4 inputs)."""

    type_names = ("concat",)
    concat_axis = 3

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert 2 <= len(in_shapes) <= 4, "concat: supports 2..4 inputs"
        out = list(in_shapes[0])
        for s in in_shapes:
            for ax in range(4):
                if ax != self.concat_axis:
                    assert s[ax] == in_shapes[0][ax], (
                        f"concat: non-concat dims must match, {s} vs "
                        f"{in_shapes[0]}")
        out[self.concat_axis] = sum(s[self.concat_axis] for s in in_shapes)
        return [tuple(out)]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 2, 4)
        return [torch.cat(inputs, dim=self.concat_axis)]


class ChConcatLayer(ConcatLayer):
    """The channel-axis concat (concat_layer template dim 1)."""

    type_names = ("ch_concat",)
    concat_axis = 1


class MaxoutLayer(Layer):
    """(n, c, h, w) -> (n, c / k, h, w): the max over each group of k =
    ``ngroup`` consecutive channels (the reference names the type but
    builds none; the JAX package's implementation)."""

    type_names = ("maxout",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "maxout: 1-1 connection only"
        n, c, h, w = in_shapes[0]
        k = self.param.num_group
        assert k > 1 and c % k == 0, "maxout: ngroup must divide channels"
        return [(n, c // k, h, w)]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0]
        n, c, h, w = x.shape
        k = self.param.num_group
        return [x.reshape(n, c // k, k, h, w).amax(dim=2)]


class EltSumLayer(Layer):
    type_names = ("eltsum",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) >= 2, "eltsum: needs at least 2 inputs"
        for s in in_shapes[1:]:
            assert s == in_shapes[0], \
                f"eltsum: input shapes differ: {s} vs {in_shapes[0]}"
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        assert len(inputs) >= 2, "eltsum: needs at least 2 inputs"
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]

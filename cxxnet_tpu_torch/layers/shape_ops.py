"""Graph plumbing layers: ``flatten`` ((n, c, h, w) -> (n, 1, 1,
c*h*w)), ``split`` (1 -> N copies) and ``eltsum`` (elementwise sum of
same-shape nodes, the residual join)."""

from __future__ import annotations

from typing import List

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

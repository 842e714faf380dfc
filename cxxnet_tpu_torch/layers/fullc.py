"""Fully-connected layer ``fullc`` (the JAX package's
``layers/fullc.py``; reference ``fullc_layer-inl.hpp``): out = in . W^T
+ bias with weight ``wmat`` (nhidden, nin) over a flat (n, 1, 1, nin)
node.  ``fixconn`` is not ported (ROADMAP.md)."""

from __future__ import annotations

from typing import List

import torch

from .base import Layer, Shape4


class FullConnectLayer(Layer):
    type_names = ("fullc",)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "fullc: 1-1 connection only"
        n, c, h, w = in_shapes[0]
        assert c == 1 and h == 1, "fullc: input must be a flat (n,1,1,d) node"
        assert self.param.num_hidden > 0, "fullc: must set nhidden"
        return [(n, 1, 1, self.param.num_hidden)]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        nin, nhidden = in_shapes[0][3], self.param.num_hidden
        params = {"wmat": self.param.rand_init_weight(
            gen, (nhidden, nin), nin, nhidden, dtype)}
        if not self.param.no_bias:
            params["bias"] = torch.full((nhidden,), self.param.init_bias,
                                        dtype=dtype, device=gen.device)
        return params

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        out = x @ params["wmat"].to(x.dtype).t()
        if "bias" in params:
            out = out + params["bias"].to(x.dtype)
        return [out.reshape(out.shape[0], 1, 1, out.shape[1])]

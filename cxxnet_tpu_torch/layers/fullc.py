"""Fully-connected layer ``fullc`` (the JAX package's
``layers/fullc.py``; reference ``fullc_layer-inl.hpp``): out = in . W^T
+ bias with weight ``wmat`` (nhidden, nin) over a flat (n, 1, 1, nin)
node, and ``fixconn`` (fixconn_layer-inl.hpp): the same product with a
fixed table read from a sparse text file, held as a buffer."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..analysis.schema import K
from .base import Layer, Shape4, as_mat


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
        x = as_mat(inputs[0])
        out = x @ params["wmat"].to(x.dtype).t()
        if "bias" in params:
            out = out + params["bias"].to(x.dtype)
        return [out.reshape(out.shape[0], 1, 1, out.shape[1])]


class FixConnectLayer(Layer):
    """A fixed (unlearned) projection out = in . W^T, W (nhidden, nin)
    read from ``fixconn_weight``: a header "nrow ncol nnz", then nnz
    "row col value" triples; held densely as the ``wmat`` buffer."""

    type_names = ("fixconn",)
    extra_config_keys = (
        K("fixconn_weight", "path",
          help="sparse projection table file"),
    )

    def __init__(self):
        super().__init__()
        self.fname_weight = "NULL"

    def set_param(self, name, val):
        if name == "fixconn_weight":
            self.fname_weight = val
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "fixconn: 1-1 connection only"
        n, c, h, w = in_shapes[0]
        assert c == 1 and h == 1, "fixconn: input must be a flat node"
        assert self.param.num_hidden > 0, "fixconn: must set nhidden"
        return [(n, 1, 1, self.param.num_hidden)]

    def init_buffers(self, in_shapes, device):
        assert self.fname_weight != "NULL", "fixconn: must set fixconn_weight"
        dense = np.zeros((self.param.num_hidden, in_shapes[0][3]), np.float32)
        with open(self.fname_weight) as f:
            toks = f.read().split()
        nrow, ncol, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        assert (nrow, ncol) == dense.shape, (
            f"fixconn: weight shape {(nrow, ncol)} != architecture "
            f"{dense.shape}")
        vals = toks[3:]
        assert len(vals) == 3 * nnz, "fixconn: invalid sparse matrix format"
        for k in range(nnz):
            dense[int(vals[3 * k]), int(vals[3 * k + 1])] = \
                float(vals[3 * k + 2])
        return {"wmat": torch.from_numpy(dense).to(device)}

    def forward_buffers(self, params, buffers, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x = as_mat(inputs[0])
        out = x @ buffers["wmat"].detach().to(x.dtype).t()
        return [out.reshape(out.shape[0], 1, 1, out.shape[1])], buffers

"""Torch plugin layer: ``layer[...] = torch`` with ``op = <name>``.

The JAX package's ``plugin/torch_adapter.py`` (reference:
``src/plugin/caffe_adapter-inl.hpp:26-228``) runs torch on the host
through ``jax.pure_callback``.  In the port there is no host round trip:
the op runs as plain ``torch.nn.functional`` with autograd on the
layer's own device, in float32 (the JAX adapter's compute type), its
output cast back to the input's dtype.  It never goes through the
port's routes (``ops/nn.py``) or its kernels, which makes it the plain
oracle that ``pairtest-<native>-torch`` holds a kernel against.

``op = conv|fullc|relu|sigmoid|tanh`` is configured by the SAME keys as
the native layer: shape inference and parameter init are delegated to
the native layer class, so tags, shapes and initialisation are
identical and a pairtest can copy the master's weights to the slave.
On the card, cuDNN and cuBLAS take their float32 math mode from
``torch.backends`` (TF32 where allowed): the caller states it.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..analysis.schema import K
from ..layers.base import ForwardContext, Layer, Params, Shape4, as_mat

# op name accepted in config -> native layer type it mirrors
_SUPPORTED = {
    "conv": "conv",
    "fullc": "fullc",
    "relu": "relu",
    "sigmoid": "sigmoid",
    "tanh": "tanh",
}


class TorchLayer(Layer):
    """``layer[...] = torch`` with ``op = <name>`` (caffe adapter
    analogue)."""

    type_names = ("torch",)
    extra_config_keys = (
        K("op", "str", help="mirrored native op name"),
    )

    def __init__(self) -> None:
        super().__init__()
        self.op = ""
        self._proxy: Layer = None  # native layer mirrored for shapes/init

    def _ensure_proxy(self) -> Layer:
        if self._proxy is None:
            if self.op not in _SUPPORTED:
                raise ValueError(
                    f"torch adapter: set op = one of {sorted(_SUPPORTED)}")
            from ..layers.registry import create_layer
            self._proxy = create_layer(_SUPPORTED[self.op])
            self._proxy.param = self.param  # share hyperparameters
        return self._proxy

    def set_param(self, name: str, val: str) -> None:
        if name == "op":
            self.op = val
            return
        super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        return self._ensure_proxy().infer_shapes(in_shapes)

    def init_params(self, gen: torch.Generator, in_shapes: List[Shape4],
                    dtype=torch.float32) -> Params:
        return self._ensure_proxy().init_params(gen, in_shapes, dtype)

    def forward(self, params: Params, inputs: List[torch.Tensor],
                ctx: ForwardContext) -> List[torch.Tensor]:
        self.check_n_inputs(inputs, 1)
        self._ensure_proxy()
        x = inputs[0]
        xf = x.float()
        p = {t: v.float() for t, v in params.items()}
        hp = self.param
        if self.op == "conv":
            out = F.conv2d(xf, p["wmat"], p.get("bias"), stride=hp.stride,
                           padding=(hp.pad_y, hp.pad_x),
                           groups=hp.num_group)
        elif self.op == "fullc":
            out = F.linear(as_mat(xf), p["wmat"], p.get("bias"))
            out = out.reshape(out.shape[0], 1, 1, out.shape[1])
        elif self.op == "relu":
            out = F.relu(xf)
        elif self.op == "sigmoid":
            out = torch.sigmoid(xf)
        else:
            out = torch.tanh(xf)
        return [out.to(x.dtype)]

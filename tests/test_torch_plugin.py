"""The port's ``torch`` plugin layer (cxxnet_tpu_torch/plugin/
torch_adapter.py) against the JAX package's TorchLayer
(cxxnet_tpu/plugin/torch_adapter.py), on the CPU.

Each op (conv, grouped and strided conv, fullc, relu, sigmoid, tanh):
the same input and weights (numpy, from a seed) through both layers,
the output and the input and weight gradients for one output gradient.
Both run torch's CPU float32 ops (the JAX layer through
``pure_callback``), so the forward is held to 1e-6 and the gradients to
1e-5 (max |diff| / max |ref|).  The plugin's shapes, parameter tags and
init come from the native layer; its keys are its section's only.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.layers.base import ForwardContext as JCtx  # noqa: E402
from cxxnet_tpu.layers.registry import create_layer as jcreate  # noqa: E402
from cxxnet_tpu_torch.engine import EngineOptions  # noqa: E402
from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx  # noqa: E402
from cxxnet_tpu_torch.layers.registry import create_layer  # noqa: E402

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

CASES = {
    "conv": ("conv", {"nchannel": 6, "kernel_size": 3, "stride": 2,
                      "pad": 1}, (2, 4, 9, 9)),
    "conv_grouped": ("conv", {"nchannel": 8, "kernel_size": 3, "ngroup": 2,
                              "pad": 1}, (2, 4, 8, 8)),
    "fullc": ("fullc", {"nhidden": 5}, (3, 1, 1, 17)),
    "relu": ("relu", {}, (2, 3, 4, 4)),
    "sigmoid": ("sigmoid", {}, (2, 3, 4, 4)),
    "tanh": ("tanh", {}, (2, 3, 4, 4)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plugin(create, op, cfg):
    lay = create("torch")
    lay.set_param("op", op)
    for k, v in cfg.items():
        lay.set_param(k, str(v))
    return lay


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_layer_matches_jax_torch_layer(case):
    op, cfg, shape = CASES[case]
    rnd = np.random.RandomState(3)
    x = rnd.randn(*shape).astype(np.float32)
    jl, tl = _plugin(jcreate, op, cfg), _plugin(create_layer, op, cfg)
    out_shape = jl.infer_shapes([shape])
    assert tl.infer_shapes([shape]) == out_shape
    jp = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(7),
                                                 [shape]))
    gen = torch.Generator()
    gen.manual_seed(7)
    tp0 = tl.init_params(gen, [shape])
    assert {t: tuple(v.shape) for t, v in tp0.items()} \
        == {t: v.shape for t, v in jp.items()}
    g = rnd.randn(*out_shape[0]).astype(np.float32)
    tags = sorted(jp)

    def jf(xv, *pv):
        (o,), _ = jl.forward(dict(zip(tags, pv)), {}, [xv],
                             JCtx(train=True))
        return o

    yj, vjp = jax.vjp(jf, jnp.asarray(x), *(jnp.asarray(jp[t])
                                            for t in tags))
    dj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {t: torch.from_numpy(jp[t]).requires_grad_() for t in tags}
    (yt,) = tl.forward(pt, [xt], TCtx(train=True, opts=EngineOptions()))
    dt = torch.autograd.grad(yt, [xt] + [pt[t] for t in tags],
                             torch.from_numpy(g))
    assert _rel(yt.detach().numpy(), yj) <= FWD_TOL
    for a, b, name in zip(dt, dj, ["x"] + tags):
        assert _rel(a.numpy(), b) <= GRAD_TOL, name


def test_torch_layer_keeps_the_input_dtype_and_device():
    """bf16 in, bf16 out, computed in float32 (the JAX adapter's compute
    type) on the input's device, and never through the port's kernels
    (no launch counter moves)."""
    from cxxnet_tpu_torch.ops import conv_wgrad
    tl = _plugin(create_layer, "conv", {"nchannel": 4, "kernel_size": 3})
    tl.infer_shapes([(2, 3, 8, 8)])
    gen = torch.Generator()
    gen.manual_seed(0)
    p = {t: v.to(torch.bfloat16) for t, v in
         tl.init_params(gen, [(2, 3, 8, 8)]).items()}
    x = torch.randn(2, 3, 8, 8, generator=gen).to(torch.bfloat16)
    before = conv_wgrad.conv_wgrad_hwcn_pallas.launches
    (y,) = tl.forward(p, [x], TCtx(train=True, opts=EngineOptions()))
    ref = torch.nn.functional.conv2d(x.float(), p["wmat"].float(),
                                     p["bias"].float())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref.to(torch.bfloat16))
    assert conv_wgrad.conv_wgrad_hwcn_pallas.launches == before


def test_torch_layer_refuses_an_unknown_op():
    tl = create_layer("torch")
    tl.set_param("op", "lrn")
    with pytest.raises(ValueError, match="set op = one of"):
        tl.infer_shapes([(1, 1, 4, 4)])


def test_torch_layer_keys_are_its_sections_only():
    """``op`` is a key of a torch section (and of a pairtest with a
    torch side), not a global key, as in the JAX package."""
    from cxxnet_tpu.analysis import registry as jreg
    from cxxnet_tpu_torch.analysis import registry
    for reg in (registry, jreg):
        assert reg.layer_key_match("torch", "op")
        assert reg.layer_key_match("pairtest-conv-torch", "slave:op")
        assert not reg.global_scope().match("op")

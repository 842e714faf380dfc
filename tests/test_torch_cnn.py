"""The port's CNN stack against the JAX package, on the CPU.

Kernels: the plain versions of the LRN (NCHW and (H, W, C, N)),
all-ties max-pool and strided conv wgrad (direct and space-to-depth)
kernels (cxxnet_tpu_torch/ops/lrn.py, pool.py, conv_wgrad.py) against
the JAX package's Pallas kernels in interpret mode, as
tests/test_pallas.py runs them, and against its XLA all-ties pool
(``ops.nn._max_pool_eq``).  Layers: each CNN layer of the port against
its JAX counterpart on one input and one output gradient.  Net and CLI:
a narrow AlexNet-shaped net under the slice's engine options from one
JAX snapshot, ``synth_device_data = 1`` and MNIST_CONV through both
CLIs.  Inputs are made with numpy from a seed and handed to both sides.
The CUDA kernels are checked on the card by tests/test_torch_gpu.py and
chip_smoke.py.

Tolerances (max |diff| / max |ref| unless said otherwise):

* forward values: 1e-6, the f32 forward envelope (ROADMAP north star);
  kernels and layers compute the same function in float32, with sums
  taken in another order;
* gradients of one kernel or layer: 1e-5 (the same, through a backward);
* gradients of a whole net after one step: 5e-3, the f32 grad envelope;
* max pools: bitwise.  The cotangents are multiples of 1/8, so every
  sum of window gradients is exact whatever its order.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu import engine as jengine  # noqa: E402
from cxxnet_tpu.ops import nn as JN  # noqa: E402
from cxxnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from cxxnet_tpu_torch.engine import EngineOptions  # noqa: E402
from cxxnet_tpu_torch.ops import conv_wgrad as cw  # noqa: E402
from cxxnet_tpu_torch.ops import lrn  # noqa: E402
from cxxnet_tpu_torch.ops import nn as TN  # noqa: E402
from cxxnet_tpu_torch.ops import pool  # noqa: E402

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
NET_GRAD_TOL = 5e-3

#: the slice's engine options (ImageNet.conf as chip_smoke.py runs it)
SLICE_OPTS = (("pool_layout", "hwcn"), ("pool_relu_fuse", "1"),
              ("pallas_lrn", "1"), ("fast_wgrad", "hwcn"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ties(rnd, shape, shift=0.0):
    """Values on a grid of 1/2 (many tied window maxima), with one
    all-equal 5x5 block per (n, c) plane at the origin."""
    x = np.round(rnd.randn(*shape) * 1.5) / 2 + shift
    x[:, :, :5, :5] = shift
    return x.astype(np.float32)


def _dyadic(rnd, shape):
    """Cotangents in multiples of 1/8: their sums are exact."""
    return (rnd.randint(-16, 17, shape) / 8).astype(np.float32)


@pytest.fixture
def jopts():
    """The JAX package's process-global engine options, restored after
    the test."""
    saved = jengine.snapshot()
    yield jengine.opts
    for k, v in saved.items():
        jengine.opts.set(k, v)


def _topts(pairs=()):
    opts = EngineOptions()
    for k, v in pairs:
        opts.set(k, v)
    return opts


# ------------------------------------------------------------------ LRN

@pytest.mark.parametrize("nsize,beta", [(5, 0.75), (4, 0.75), (3, 0.6)])
def test_lrn_plain_matches_pallas_interpret(nsize, beta):
    """lrn_fwd_plain / lrn_bwd_plain == lrn_pallas and its vjp (interpret
    mode), n odd and even (the transposed backward window), the rsqrt
    path at beta 0.75 and the pow path: forward FWD_TOL, dx GRAD_TOL.
    The port's autograd Function runs the plain versions on the CPU, and
    the hand-derived backward is the true gradient of the forward."""
    rnd = np.random.RandomState(0)
    x = (rnd.randn(2, 12, 5, 6) * 2).astype(np.float32)
    g = rnd.randn(*x.shape).astype(np.float32)
    args = (nsize, 0.01, beta, 1.0)
    y_j, vjp = jax.vjp(lambda v: pk.lrn_pallas(v, *args), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    y_t = lrn.lrn_fwd_plain(_t(x), *args)
    dx_t = lrn.lrn_bwd_plain(_t(x), _t(g), *args)
    assert _rel(y_t, y_j) <= FWD_TOL
    assert _rel(dx_t, dx_j) <= GRAD_TOL
    xt = _t(x).requires_grad_()
    y = lrn.lrn_pallas(xt, *args)
    (dx,) = torch.autograd.grad(y, xt, _t(g))
    assert torch.equal(y, y_t) and torch.equal(dx, dx_t)
    assert (lrn.lrn_fwd.launches, lrn.lrn_bwd.launches) == (0, 0)
    xt = _t(x).double().requires_grad_()
    norm = TN.chpool_sum(xt * xt, nsize) * (0.01 / nsize) + 1.0
    (dx_auto,) = torch.autograd.grad(xt * norm ** -beta, xt, _t(g).double())
    assert _rel(dx_t, dx_auto) <= GRAD_TOL


@pytest.mark.parametrize("nsize,beta", [(5, 0.75), (4, 0.75), (3, 0.6)])
def test_lrn_hwcn_plain_matches_pallas_interpret(nsize, beta):
    """lrn_pallas_hwcn of the port (its autograd Function over the plain
    (H, W, C, N) versions on the CPU) == the JAX package's lrn_pallas_hwcn
    (interpret mode) and its vjp: forward FWD_TOL, dx GRAD_TOL; the same
    values as the NCHW lrn_pallas, the window along C either way."""
    rnd = np.random.RandomState(12)
    x = (rnd.randn(3, 12, 5, 6) * 2).astype(np.float32)
    g = rnd.randn(*x.shape).astype(np.float32)
    args = (nsize, 0.01, beta, 1.0)
    y_j, vjp = jax.vjp(lambda v: pk.lrn_pallas_hwcn(v, *args),
                       jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y = lrn.lrn_pallas_hwcn(xt, *args)
    (dx,) = torch.autograd.grad(y, xt, _t(g))
    assert y.is_contiguous() and dx.is_contiguous()
    assert _rel(y.detach(), y_j) <= FWD_TOL and _rel(dx, dx_j) <= GRAD_TOL
    xt = _t(x).requires_grad_()
    (dx_nchw,) = torch.autograd.grad(lrn.lrn_pallas(xt, *args), xt, _t(g))
    assert _rel(dx, dx_nchw) <= GRAD_TOL
    assert (lrn.lrn_hwcn_fwd.launches, lrn.lrn_hwcn_bwd.launches) == (0, 0)


@pytest.mark.parametrize("shape", [
    (256, 96, 27, 27),    # AlexNet lrn1
    (256, 256, 13, 13),   # AlexNet lrn2
    (128, 8, 5, 5),
    (100, 8, 5, 5),       # batch off the 128-image tile
    (128, 64, 65, 65),    # plane wider than 64
    (128, 192, 56, 56),   # GoogLeNet: within 3 MiB
    (128, 512, 28, 28),   # over 3 MiB
])
def test_lrn_hwcn_gate_matches_jax(monkeypatch, shape):
    """lrn_hwcn_fits == the JAX package's _lrn_hwcn_fits with its backend
    reading TPU: the same layers take the (H, W, C, N) kernels in both
    packages (the port's gate reads no device)."""
    monkeypatch.setattr(JN.jax, "default_backend", lambda: "tpu")
    assert lrn.lrn_hwcn_fits(shape) == JN._lrn_hwcn_fits(shape)
    if shape[0] == 256:
        assert lrn.lrn_hwcn_fits(shape)


@pytest.mark.parametrize("shape", [(128, 8, 5, 5), (4, 8, 5, 5)])
def test_lrn_routes_under_pallas_lrn_hwcn(jopts, monkeypatch, shape):
    """nn.lrn under ``pallas_lrn = hwcn``: a shape inside the gate goes
    through lrn_pallas_hwcn, one outside it through the plain form; both
    equal the JAX package's nn.lrn under the same option (which on the
    CPU computes the same function in XLA) within FWD_TOL / GRAD_TOL."""
    calls = []
    real = lrn.lrn_pallas_hwcn
    monkeypatch.setattr(lrn, "lrn_pallas_hwcn",
                        lambda *a: calls.append(1) or real(*a))
    jopts.set("pallas_lrn", "hwcn")
    rnd = np.random.RandomState(13)
    x = (rnd.randn(*shape) * 2).astype(np.float32)
    g = rnd.randn(*shape).astype(np.float32)
    args = (5, 0.001, 0.75, 1.0)
    y_j, vjp = jax.vjp(lambda v: JN.lrn(v, *args), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y = TN.lrn(xt, *args, opts=_topts([("pallas_lrn", "hwcn")]))
    (dx,) = torch.autograd.grad(y, xt, _t(g))
    assert len(calls) == int(shape[0] == 128)
    assert _rel(y.detach(), y_j) <= FWD_TOL and _rel(dx, dx_j) <= GRAD_TOL


# ------------------------------------------------------------- max pool

@pytest.mark.parametrize("shape,k,s,relu", [
    ((2, 4, 13, 13), 3, 2, False),   # AlexNet pool family, clipped tail
    ((2, 4, 13, 13), 3, 2, True),    # relu-fused, post-relu zeros
    ((2, 3, 12, 12), 2, 2, True),    # LeNet pool family
])
def test_max_pool_plain_matches_pallas_interpret_bitwise(shape, k, s, relu):
    """max_pool_hwcn / max_pool_relu_hwcn of the port (plain versions on
    the CPU) == the Pallas kernels in interpret mode, forward and the
    all-ties gradient, bitwise, on inputs with tied maxima, all-equal
    windows and (relu) maxima at and below zero."""
    rnd = np.random.RandomState(1)
    x = _ties(rnd, shape, shift=-0.5 if relu else 0.0)
    jfn = pk.max_pool_relu_hwcn if relu else pk.max_pool_hwcn
    tfn = pool.max_pool_relu_hwcn if relu else pool.max_pool_hwcn
    y_j, vjp = jax.vjp(lambda v: jfn(v, k, s), jnp.asarray(x))
    g = _dyadic(rnd, y_j.shape)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y_t = tfn(xt, k, k, s)
    (dx_t,) = torch.autograd.grad(y_t, xt, _t(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))
    # the inputs do exercise ties: unit window gradients reach more
    # inputs, in all, than there are windows
    pre = pool.max_pool_fwd_plain(_t(x), (k, k, s, 0, 0))
    assert (pool.max_pool_bwd_plain(_t(x), pre, torch.ones_like(pre),
                                    (k, k, s, 0, 0)).sum() > pre.numel())
    if relu:
        assert (pre == 0).any() and (pre < 0).any()
    assert (pool.max_pool_fwd.launches, pool.max_pool_bwd.launches) == (0, 0)


@pytest.mark.parametrize("shape,geom", [
    ((2, 3, 13, 13), (3, 3, 2, 0, 0)),   # AlexNet pool1/2/5 family
    ((2, 3, 12, 12), (3, 3, 2, 0, 0)),   # even width, clipped tail
    ((2, 3, 12, 12), (2, 2, 2, 0, 0)),   # non-overlapping
    ((2, 3, 7, 8), (3, 3, 1, 0, 0)),     # stride 1: nine windows an input
    ((2, 3, 11, 11), (3, 3, 2, 1, 1)),   # padded
    ((2, 3, 9, 10), (3, 2, 1, 1, 1)),    # padded, non-square window
    ((1, 2, 14, 14), (3, 3, 2, 0, 0)),   # MNIST_CONV pool
])
@pytest.mark.parametrize("relu", [False, True])
def test_max_pool_plain_matches_xla_all_ties_bitwise(shape, geom, relu):
    """The same functions against the JAX package's XLA all-ties pool
    (``_max_pool_eq``, then its relu, whose gradient is masked by the
    output), including the padded and non-square windows the TPU kernel
    does not take: bitwise."""
    from cxxnet_tpu.layers.activation import apply_relu
    kh, kw, s, py, px = geom
    rnd = np.random.RandomState(2)
    x = _ties(rnd, shape, shift=-0.5 if relu else 0.0)

    def jfn(v):
        y = JN._max_pool_eq(v, kh, kw, s, py, px)
        return apply_relu(y) if relu else y

    y_j, vjp = jax.vjp(jfn, jnp.asarray(x))
    g = _dyadic(rnd, y_j.shape)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    fn = pool.max_pool_relu_hwcn if relu else pool.max_pool_hwcn
    y_t = fn(xt, kh, kw, s, py, px)
    (dx_t,) = torch.autograd.grad(y_t, xt, _t(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))


@pytest.mark.parametrize("shape,geom", [
    ((1, 1, 5, 5), (3, 3, 2, 0, 0)),     # every window all ties
    ((1, 2, 6, 7), (3, 3, 2, 1, 1)),     # padded: -inf never wins
    ((1, 1, 8, 8), (2, 2, 2, 0, 0)),
])
def test_default_pool_tie_winner_matches_xla_select_and_scatter(shape,
                                                                  geom):
    """The default ``pool_bwd = sas``: on all-tied windows the port's
    one-winner backward sends each window's gradient to the same input
    as XLA's select-and-scatter (the JAX package's reduce_window vjp):
    the first maximum in row-major window order.  Bitwise."""
    kh, kw, s, py, px = geom
    rnd = np.random.RandomState(3)
    x = np.zeros(shape, np.float32)
    x[..., 1::3, :] = 1.0   # some windows tie at 1, some at 0
    y_j, vjp = jax.vjp(lambda v: JN._max_pool_raw(v, kh, kw, s, py, px),
                       jnp.asarray(x))
    g = _dyadic(rnd, y_j.shape)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y_t = TN.max_pool2d(xt, kh, kw, s, py, px, opts=_topts())
    (dx_t,) = torch.autograd.grad(y_t, xt, _t(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))
    # one winner: each window's gradient lands on exactly one input
    assert int((dx_t != 0).sum()) <= g.size


# ----------------------------------------------------------- conv wgrad

@pytest.mark.parametrize("n,c,h,co,k,s,pad", [
    (2, 3, 23, 8, 11, 4, 0),    # AlexNet conv1 class
    (2, 1, 10, 6, 3, 2, 1),     # MNIST_CONV conv1 class, padded
])
def test_conv_wgrad_plain_matches_pallas_interpret(n, c, h, co, k, s, pad):
    """conv_wgrad_plain == conv_wgrad_hwcn_pallas (interpret mode): dW
    (co, ci, kh, kw) and db (co,) in float32 within GRAD_TOL.  The
    port's conv_bias_fast Function gives the same dW / db, cast to the
    weight dtype, and dx equal to F.conv2d's."""
    rnd = np.random.RandomState(4)
    x = rnd.randn(n, c, h, h).astype(np.float32)
    w = (rnd.randn(co, c, k, k) * 0.1).astype(np.float32)
    b = rnd.randn(co).astype(np.float32)
    oh = (h + 2 * pad - k) // s + 1
    dy = rnd.randn(n, co, oh, oh).astype(np.float32)
    dw_j, db_j = pk.conv_wgrad_hwcn_pallas(jnp.asarray(x), jnp.asarray(dy),
                                           kh=k, kw=k, stride=s, pad_y=pad,
                                           pad_x=pad)
    dw_t, db_t = cw.conv_wgrad_hwcn_pallas(_t(x), _t(dy), k, k, s, pad, pad)
    assert dw_t.dtype == db_t.dtype == torch.float32
    assert _rel(dw_t, dw_j) <= GRAD_TOL and _rel(db_t, db_j) <= GRAD_TOL
    assert cw.conv_wgrad_hwcn_pallas.launches == 0
    for mode in ("hwcn", "s2d"):
        xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
        out = cw.conv_bias_fast(xt, wt, bt, s, pad, pad, mode)
        grads = torch.autograd.grad(out, (xt, wt, bt), _t(dy))
        xr, wr, br = (_t(a).requires_grad_() for a in (x, w, b))
        ref = F.conv2d(xr, wr, br, stride=s, padding=pad)
        want = torch.autograd.grad(ref, (xr, wr, br), _t(dy))
        assert _rel(out.detach(), ref.detach()) <= FWD_TOL
        for got, exp in zip(grads, want):
            assert _rel(got, exp) <= GRAD_TOL
        assert torch.equal(grads[1], dw_t) and torch.equal(grads[2], db_t)


@pytest.mark.parametrize("n,c,h,co,k,s,pad", [
    (2, 3, 23, 8, 11, 4, 0),    # AlexNet conv1 class: kb 3
    (2, 1, 10, 6, 3, 2, 1),     # MNIST_CONV conv1 class
    (2, 2, 17, 5, 4, 3, 2),     # unconsumed tail rows, padding
])
def test_s2d_input_and_wgrad_match_jax(n, c, h, co, k, s, pad):
    """s2d_input == the JAX package's (a pure rearrangement: bitwise),
    and the fast_wgrad = s2d weight gradient through it equals torch's
    strided conv2d_weight within GRAD_TOL."""
    from torch.nn.grad import conv2d_weight
    rnd = np.random.RandomState(10)
    x = rnd.randn(n, c, h, h).astype(np.float32)
    oh = (h + 2 * pad - k) // s + 1
    dy = rnd.randn(n, co, oh, oh).astype(np.float32)
    xb, kb_y, kb_x = TN.s2d_input(_t(x), s, k, k, oh, oh, pad, pad)
    jb, jkb_y, jkb_x = JN.s2d_input(jnp.asarray(x), s, k, k, oh, oh, pad,
                                    pad)
    assert (kb_y, kb_x) == (jkb_y, jkb_x)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jb))
    dw = cw.wgrad_s2d(_t(x), _t(dy), k, k, s, pad, pad)
    ref = conv2d_weight(_t(x), (co, c, k, k), _t(dy), stride=s, padding=pad)
    assert _rel(dw, ref) <= GRAD_TOL


@pytest.mark.parametrize("n,c,h,co,k,s,pad", [
    (2, 3, 23, 8, 11, 4, 0),    # AlexNet conv1 class: kb 3
    (2, 1, 10, 6, 3, 2, 1),     # MNIST_CONV conv1 class, padded
    (3, 2, 17, 5, 4, 3, 2),     # unconsumed tail rows, padding
])
def test_conv_wgrad_s2d_plain_matches_pallas_interpret(n, c, h, co, k, s,
                                                       pad):
    """conv_wgrad_s2d_pallas of the port (its plain version on the CPU)
    == the JAX package's conv_wgrad_s2d_pallas (interpret mode, as its
    ``fast_wgrad = pallas`` runs it): dW and db in float32 within
    GRAD_TOL, and the same as the direct wgrad; conv_bias_fast's
    ``pallas`` mode gives that dW / db and F.conv2d's dx."""
    rnd = np.random.RandomState(14)
    x = rnd.randn(n, c, h, h).astype(np.float32)
    w = (rnd.randn(co, c, k, k) * 0.1).astype(np.float32)
    b = rnd.randn(co).astype(np.float32)
    oh = (h + 2 * pad - k) // s + 1
    dy = rnd.randn(n, co, oh, oh).astype(np.float32)
    dw_j, db_j = pk.conv_wgrad_s2d_pallas(jnp.asarray(x), jnp.asarray(dy),
                                          kh=k, kw=k, stride=s, pad_y=pad,
                                          pad_x=pad, interpret=True)
    dw_t, db_t = cw.conv_wgrad_s2d_pallas(_t(x), _t(dy), k, k, s, pad, pad)
    assert dw_t.shape == (co, c, k, k) and db_t.shape == (co,)
    assert _rel(dw_t, dw_j) <= GRAD_TOL and _rel(db_t, db_j) <= GRAD_TOL
    dw_d, db_d = cw.conv_wgrad_plain(_t(x), _t(dy), k, k, s, pad, pad)
    assert _rel(dw_t, dw_d) <= GRAD_TOL and _rel(db_t, db_d) <= GRAD_TOL
    assert cw.conv_wgrad_s2d_pallas.launches == 0
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
    out = cw.conv_bias_fast(xt, wt, bt, s, pad, pad, "pallas")
    grads = torch.autograd.grad(out, (xt, wt, bt), _t(dy))
    xr = _t(x).requires_grad_()
    ref = F.conv2d(xr, _t(w), _t(b), stride=s, padding=pad)
    (dx_ref,) = torch.autograd.grad(ref, xr, _t(dy))
    assert _rel(out.detach(), ref.detach()) <= FWD_TOL
    assert _rel(grads[0], dx_ref) <= GRAD_TOL
    assert torch.equal(grads[1], dw_t) and torch.equal(grads[2], db_t)


# --------------------------------------------------------------- layers

def _layer_grads(type_name, cfg, x, params, g, pairs=(), train=True,
                 jopts=None):
    """One layer of each package on x with the same params: (output, dx,
    {tag: dparam}) of each, for output gradient g."""
    from cxxnet_tpu.layers.base import ForwardContext as JCtx
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx
    from cxxnet_tpu_torch.layers.registry import create_layer as tcreate
    jl, tl = jcreate(type_name), tcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
        tl.set_param(k, v)
    assert jl.infer_shapes([x.shape]) == tl.infer_shapes([x.shape])
    for k, v in pairs:
        jopts.set(k, v)
    tags = sorted(params)

    def jf(xv, *pv):
        ctx = JCtx(train=train, rng=jax.random.PRNGKey(0))
        outs, _ = jl.forward(dict(zip(tags, pv)), {}, [xv], ctx)
        return outs[0]

    y_j, vjp = jax.vjp(jf, jnp.asarray(x), *(jnp.asarray(params[t])
                                             for t in tags))
    dj = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    pt = {t: _t(params[t]).requires_grad_() for t in tags}
    gen = torch.Generator()
    gen.manual_seed(0)
    ctx = TCtx(train=train, opts=_topts(pairs), rng=gen)
    y_t = tl.forward(pt, [xt], ctx)[0]
    dt = torch.autograd.grad(y_t, [xt] + [pt[t] for t in tags], _t(g),
                             allow_unused=True)
    return ((np.asarray(y_j), np.asarray(dj[0]),
             {t: np.asarray(d) for t, d in zip(tags, dj[1:])}),
            (y_t.detach().numpy(), dt[0].numpy(),
             {t: d.numpy() for t, d in zip(tags, dt[1:])}))


_CONV = [("kernel_size", "3"), ("nchannel", "6")]
_LAYER_CASES = {
    "conv_grouped": ("conv", _CONV + [("ngroup", "2"), ("pad", "1"),
                                      ("stride", "2")], (2, 4, 9, 9), ()),
    "conv_conv1_class_hwcn": ("conv", [("kernel_size", "5"),
                                       ("nchannel", "6"), ("stride", "2")],
                              (2, 3, 11, 11), (("fast_wgrad", "hwcn"),)),
    "conv_conv1_class_s2d": ("conv", [("kernel_size", "5"),
                                      ("nchannel", "6"), ("stride", "2")],
                             (2, 3, 11, 11), ()),
    "conv_no_bias": ("conv", _CONV + [("no_bias", "1")], (2, 4, 7, 7), ()),
    "max_pooling_hwcn": ("max_pooling", [("kernel_size", "3"),
                                         ("stride", "2")], (2, 3, 12, 12),
                         (("pool_layout", "hwcn"),)),
    "max_pooling_padded_eq": ("max_pooling", [("kernel_size", "3"),
                                              ("stride", "2"),
                                              ("pad", "1")], (2, 3, 11, 11),
                              (("pool_bwd", "eq"),)),
    "max_pooling_sas": ("max_pooling", [("kernel_size", "3"),
                                        ("stride", "2")], (2, 3, 13, 13), ()),
    "relu_max_pooling_fused": ("relu_max_pooling", [("kernel_size", "3"),
                                                    ("stride", "2")],
                               (2, 3, 13, 13), (("pool_relu_fuse", "1"),
                                                ("pool_layout", "hwcn"))),
    "relu_max_pooling_no_reorder": ("relu_max_pooling",
                                    [("kernel_size", "2"), ("stride", "2")],
                                    (2, 3, 12, 12),
                                    (("pool_relu_reorder", "0"),)),
    "sum_pooling_tail": ("sum_pooling", [("kernel_size", "3"),
                                         ("stride", "2")], (2, 3, 12, 12),
                         ()),
    "avg_pooling_tail": ("avg_pooling", [("kernel_size", "3"),
                                         ("stride", "2")], (2, 3, 12, 12),
                         ()),
    "avg_pooling_padded": ("avg_pooling", [("kernel_size", "3"),
                                           ("stride", "2"), ("pad", "1")],
                           (2, 3, 9, 9), ()),
    "fullc": ("fullc", [("nhidden", "5")], (3, 1, 1, 12), ()),
    "flatten": ("flatten", [], (2, 3, 4, 5), ()),
    "relu": ("relu", [], (2, 3, 4, 5), ()),
    "sigmoid": ("sigmoid", [], (2, 3, 4, 5), ()),
    "tanh": ("tanh", [], (2, 3, 4, 5), ()),
    "softplus": ("softplus", [], (2, 3, 4, 5), ()),
    "dropout_threshold_0": ("dropout", [("threshold", "0")], (2, 3, 4, 5),
                            ()),
}
for _v in ("band", "bandconv", "1", "0"):
    _LAYER_CASES[f"lrn_pallas_lrn_{_v}"] = (
        "lrn", [("local_size", "5"), ("alpha", "0.01"), ("beta", "0.75"),
                ("knorm", "1")], (2, 8, 5, 5), (("pallas_lrn", _v),))


def _layer_params(type_name, cfg, in_shape, rnd):
    d = dict(cfg)
    if type_name == "conv":
        co, k = int(d["nchannel"]), int(d["kernel_size"])
        ci = in_shape[1] // int(d.get("ngroup", "1"))
        p = {"wmat": rnd.randn(co, ci, k, k) * 0.2}
        if d.get("no_bias") != "1":
            p["bias"] = rnd.randn(co)
        return {t: v.astype(np.float32) for t, v in p.items()}
    if type_name == "fullc":
        nh = int(d["nhidden"])
        return {"wmat": rnd.randn(nh, in_shape[3]).astype(np.float32) * 0.3,
                "bias": rnd.randn(nh).astype(np.float32)}
    return {}


@pytest.mark.parametrize("case", sorted(_LAYER_CASES))
def test_layer_matches_jax(case, jopts):
    """Each CNN layer of the port against the JAX layer of the same type
    and config on one input, with the same params: output FWD_TOL, dx and
    every param gradient GRAD_TOL; max pools bitwise (dyadic output
    gradients).  Covers grouped and conv1-class convs (the port's
    conv_bias_fast under both fast_wgrad values against the JAX
    package's plain conv off the TPU), every pool type with the avg
    pool's full-kernel divisor on clipped tail and padded windows, lrn
    under every pallas_lrn value, fullc, activations and dropout at
    threshold 0 in a training forward."""
    type_name, cfg, shape, pairs = _LAYER_CASES[case]
    rnd = np.random.RandomState(5)
    x = rnd.randn(*shape).astype(np.float32)
    params = _layer_params(type_name, cfg, shape, rnd)
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    jl = jcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
    out_shape = jl.infer_shapes([shape])[0]
    g = _dyadic(rnd, out_shape)
    (yj, dxj, dpj), (yt, dxt, dpt) = _layer_grads(
        type_name, cfg, x, params, g, pairs, jopts=jopts)
    if type_name.endswith("max_pooling"):
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(dxt, dxj)
    else:
        assert _rel(yt, yj) <= FWD_TOL
        assert _rel(dxt, dxj) <= GRAD_TOL
    assert set(dpt) == set(dpj)
    for tag in dpj:
        assert _rel(dpt[tag], dpj[tag]) <= GRAD_TOL, tag


def test_avg_pool_divides_tail_windows_by_the_full_kernel():
    """avg_pool2d divides a clipped tail window by kh * kw, as the
    reference does, where F.avg_pool2d(ceil_mode=True) divides by the
    clipped count."""
    x = torch.ones((1, 1, 4, 4))
    y = TN.avg_pool2d(x, 3, 3, 2)
    assert y.shape == (1, 1, 2, 2)
    assert float(y[0, 0, 0, 0]) == 1.0
    assert float(y[0, 0, 1, 1]) == pytest.approx(4.0 / 9.0)
    assert float(F.avg_pool2d(x, 3, 2, ceil_mode=True)[0, 0, 1, 1]) == 1.0


def test_dropout_with_injected_mask_matches_jax(jopts, monkeypatch):
    """Dropout at threshold 0.5 with one numpy mask handed to both
    packages (their random streams differ): output and dx FWD_TOL."""
    from cxxnet_tpu.ops import nn as jnn
    rnd = np.random.RandomState(6)
    x = rnd.randn(4, 3, 5, 5).astype(np.float32)
    keep = (rnd.rand(*x.shape) < 0.5).astype(np.float32) / 0.5
    monkeypatch.setattr(jnn, "dropout_mask",
                        lambda key, shape, pkeep, dtype: jnp.asarray(keep))
    monkeypatch.setattr(TN, "dropout_mask",
                        lambda gen, shape, pkeep, dtype: _t(keep))
    g = rnd.randn(*x.shape).astype(np.float32)
    (yj, dxj, _), (yt, dxt, _) = _layer_grads(
        "dropout", [("threshold", "0.5")], x, {}, g, jopts=jopts)
    assert _rel(yt, yj) <= FWD_TOL and _rel(dxt, dxj) <= FWD_TOL
    assert (yt == 0).mean() > 0.3
    (_, _, _), (ye, _, _) = _layer_grads(
        "dropout", [("threshold", "0.5")], x, {}, g, train=False,
        jopts=jopts)
    np.testing.assert_array_equal(ye, x)


def test_dropout_mask_is_the_reference_threshold():
    """The port's own mask: keep with probability pkeep, kept values
    scaled by 1 / pkeep, drawn from the trainer's generator."""
    gen = torch.Generator()
    gen.manual_seed(3)
    m = TN.dropout_mask(gen, (200, 100), 0.75, torch.float32)
    assert set(np.unique(m.numpy()).tolist()) == {0.0, np.float32(1 / 0.75)}
    assert abs(float((m > 0).float().mean()) - 0.75) < 0.02


@pytest.mark.parametrize("loss", ["softmax", "l2_loss", "multi_logistic"])
def test_loss_layer_matches_jax(loss):
    """softmax / l2_loss / multi_logistic: the training forward's loss
    (scaled by 1 / batch) and its gradient, and the output transform,
    against the JAX layers: FWD_TOL and GRAD_TOL."""
    from cxxnet_tpu.layers.base import ForwardContext as JCtx
    from cxxnet_tpu.layers.base import LabelInfo as JLabel
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx
    from cxxnet_tpu_torch.layers.base import LabelInfo as TLabel
    from cxxnet_tpu_torch.layers.registry import create_layer as tcreate
    rnd = np.random.RandomState(7)
    n, k = 5, 6
    x = rnd.randn(n, 1, 1, k).astype(np.float32)
    if loss == "softmax":
        lab = rnd.randint(0, k, (n, 1)).astype(np.float32)
    elif loss == "l2_loss":
        lab = rnd.randn(n, k).astype(np.float32)
    else:
        lab = (rnd.rand(n, k) < 0.5).astype(np.float32)
    jl, tl = jcreate(loss), tcreate(loss)

    def jf(xv):
        ctx = JCtx(train=True, labels=JLabel(fields={"label":
                                                     jnp.asarray(lab)}),
                   loss_scale=1.0 / n)
        out, _ = jl.forward({}, {}, [xv], ctx)
        return sum(ctx.losses), out[0]

    (lj, oj), dj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    ctx = TCtx(train=True, opts=_topts(),
               labels=TLabel(fields={"label": _t(lab)}), loss_scale=1.0 / n)
    ot = tl.forward({}, [xt], ctx)[0]
    lt = sum(ctx.losses)
    (dt,) = torch.autograd.grad(lt, xt)
    assert _rel(float(lt.detach()), float(lj)) <= FWD_TOL
    assert _rel(ot.detach().numpy(), oj) <= FWD_TOL
    assert _rel(dt.numpy(), dj) <= GRAD_TOL


# ------------------------------------------------------- net and trainer

def _alexnet_narrow():
    """AlexNet's layer sequence (ImageNet.conf) at input 3x67x67 and
    channels 8-16, fullc 32, no dropout."""
    return """
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 8
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  nchannel = 16
  kernel_size = 5
  pad = 2
layer[5->6] = relu
layer[6->7] = max_pooling
  kernel_size = 3
  stride = 2
layer[7->8] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  nchannel = 16
  kernel_size = 3
  pad = 1
layer[9->10] = relu
layer[10->11] = conv:conv4
  nchannel = 16
  ngroup = 2
  kernel_size = 3
  pad = 1
layer[11->12] = relu
layer[12->13] = conv:conv5
  nchannel = 16
  ngroup = 2
  kernel_size = 3
  pad = 1
  init_bias = 1.0
layer[13->14] = relu
layer[14->15] = max_pooling
  kernel_size = 3
  stride = 2
layer[15->16] = flatten
layer[16->17] = fullc:fc6
  nhidden = 32
  init_bias = 1.0
layer[17->18] = relu
layer[18->19] = fullc:fc7
  nhidden = 32
layer[19->20] = relu
layer[20->21] = fullc:fc8
  nhidden = 10
layer[21->21] = softmax
netconfig=end
input_shape = 3,67,67
"""


#: ImageNet.conf's updater keys
_SGD_KEYS = [("updater", "sgd"), ("momentum", "0.9"), ("wmat:lr", "0.01"),
             ("wmat:wd", "0.0005"), ("bias:wd", "0.000"),
             ("bias:lr", "0.02"), ("lr:schedule", "factor"),
             ("lr:factor", "0.1"), ("lr:step", "100000"),
             ("random_type", "xavier")]


def _cnn_pair(net, batch, keys):
    """(JAX trainer, port trainer) on ``net``, the port's params from the
    JAX trainer's."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    from cxxnet_tpu_torch.utils.config import parse_config_string
    keys = list(keys) + [("eval_train", "0"), ("silent", "1")]
    jt = _make_trainer(net, batch, "cpu", extra=keys)
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in [("batch_size", str(batch)), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


def _synth_batch(shape, nclass, seed):
    """A DataBatch of uniform [0, 1) data and uniform class labels."""
    from cxxnet_tpu_torch.io.data import DataBatch
    rnd = np.random.RandomState(seed)
    return DataBatch(
        data=rnd.rand(*shape).astype(np.float32),
        label=rnd.randint(0, nclass, (shape[0], 1)).astype(np.float32),
        index=np.arange(shape[0], dtype=np.uint32))


def test_alexnet_narrow_step_grads_match_jax(jopts):
    """The narrow AlexNet under the slice's options (pool_layout hwcn,
    pool_relu_fuse 1, pallas_lrn 1, fast_wgrad hwcn), batch 4, from one
    JAX snapshot: the loss within FWD_TOL and every gradient within
    NET_GRAD_TOL.  The port's relu -> pool reorder moved every relu
    after its pool and the bias of conv2 (not of the conv1-class conv,
    whose one wgrad computes db) to the pooled tensor."""
    jt, tt = _cnn_pair(_alexnet_narrow(), 4, _SGD_KEYS + list(SLICE_OPTS))
    conns = tt.net.connections
    assert [c.layer.relu_after for c in conns
            if type(c.layer).__name__ == "MaxPoolingLayer"] == [True] * 3
    assert (conns[0].layer.defer_bias, conns[4].layer.defer_bias) == (0, 1)
    batch = _synth_batch((4, 3, 67, 67), 10, 8)
    (jloss, _), jgrads = jt._loss_and_grads(
        jt.params, jt.buffers, jnp.asarray(batch.data),
        jnp.asarray(batch.label), (), jnp.int32(0), jax.random.PRNGKey(0),
        ())
    tloss, tgrads = tt.loss_and_grads(batch)
    assert _rel(float(tloss), float(jloss)) <= FWD_TOL
    assert set(tgrads) == set(jgrads)
    for key, group in jgrads.items():
        for tag, g in group.items():
            err = _rel(tgrads[key][tag].numpy(), np.asarray(g))
            assert err <= NET_GRAD_TOL, (key, tag, err)


def test_alexnet_narrow_hwcn_pallas_step_grads_match_nchw_kernels(jopts):
    """The narrow AlexNet at batch 128 under ``pallas_lrn = hwcn
    fast_wgrad = pallas`` against the same net and weights under
    ``pallas_lrn = 1 fast_wgrad = hwcn`` (held to the JAX trainer by
    test_alexnet_narrow_step_grads_match_jax; a JAX trainer at batch 128
    takes ~20 s on a CPU): both LRNs take the (H, W, C, N) Function and
    conv1's dW / db the space-to-depth wgrad, and the loss and every
    gradient agree within FWD_TOL and GRAD_TOL (one function, summed in
    other orders)."""
    from cxxnet_tpu_torch.layers.conv import LRNLayer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    batch = _synth_batch((128, 3, 67, 67), 10, 15)
    calls = {"lrn": 0, "wgrad": 0}
    real_lrn, real_wgrad = lrn.lrn_pallas_hwcn, cw.conv_wgrad_s2d_pallas

    def lrn_spy(*a):
        calls["lrn"] += 1
        return real_lrn(*a)

    def wgrad_spy(*a):
        calls["wgrad"] += 1
        return real_wgrad(*a)

    out = {}
    for name, opts in (("nchw", SLICE_OPTS),
                       ("hwcn", (("pool_layout", "hwcn"),
                                 ("pool_relu_fuse", "1"),
                                 ("pallas_lrn", "hwcn"),
                                 ("fast_wgrad", "pallas")))):
        tt = NetTrainer()
        for k, v in parse_config_string(_alexnet_narrow()):
            tt.set_param(k, v)
        for k, v in [("batch_size", "128"), ("dev", "cpu"), ("seed", "3"),
                     ("eval_train", "0"), ("silent", "1")] + _SGD_KEYS \
                + list(opts):
            tt.set_param(k, v)
        tt.init_model()
        lrn.lrn_pallas_hwcn, cw.conv_wgrad_s2d_pallas = lrn_spy, wgrad_spy
        try:
            out[name] = tt.loss_and_grads(batch)
        finally:
            lrn.lrn_pallas_hwcn = real_lrn
            cw.conv_wgrad_s2d_pallas = real_wgrad
    assert sum(type(c.layer) is LRNLayer for c in tt.net.connections) == 2
    assert calls == {"lrn": 2, "wgrad": 1}
    (ref_loss, ref), (loss, grads) = out["nchw"], out["hwcn"]
    assert _rel(float(loss), float(ref_loss)) <= FWD_TOL
    for key, group in ref.items():
        for tag, g in group.items():
            assert _rel(grads[key][tag], g) <= GRAD_TOL, (key, tag)


def test_cnn_trains_on_from_jax_sgd_state(jopts, tmp_path):
    """One sgd-momentum step in the JAX trainer on a LeNet, saved with
    its optimizer state as a .model; the port loads it (params, momentum
    ``m``) and both take two more steps: losses within rel 1e-5, params
    within 1e-5.  A bf16 snapshot carries float32 masters, which the
    port installs as its own."""
    from cxxnet_tpu.models import lenet as jlenet
    from cxxnet_tpu_torch.models import lenet
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    assert lenet() == jlenet()
    keys = [("updater", "sgd"), ("eta", "0.05"), ("momentum", "0.9"),
            ("wd", "0.0001")]
    jt, _ = _cnn_pair(lenet(), 4, keys)
    batches = [_synth_batch((4, 1, 28, 28), 10, s) for s in (10, 11, 12)]
    jt.update(batches[0])
    path = str(tmp_path / "j.model")
    jt.save_model(path, with_opt_state=True)
    tt = NetTrainer()
    for k, v in [("batch_size", "4"), ("dev", "cpu"), ("silent", "1"),
                 ("eval_train", "0")] + keys:
        tt.set_param(k, v)
    tt.load_model(path)
    assert tt.epoch_counter == jt.epoch_counter == 1
    for b in batches[1:]:
        jt.update(b)
        tt.update(b)
        jl = float(jt._last_loss)
        assert abs(float(tt.last_loss) - jl) <= 1e-5 * abs(jl)
    assert set(tt.opt_state) == set(jt.opt_state)
    assert all(set(st) == {"m"} for g in tt.opt_state.values()
               for st in g.values())
    for key, group in jt.params.items():
        for tag, v in group.items():
            np.testing.assert_allclose(tt.params[key][tag].numpy(),
                                       np.asarray(v), atol=1e-5,
                                       err_msg=f"{key}/{tag}")
    jb, _ = _cnn_pair(lenet(), 4, keys + [("dtype", "bfloat16")])
    jb.update(batches[0])
    jb.save_model(path, with_opt_state=True)
    tb = NetTrainer()
    for k, v in [("batch_size", "4"), ("dev", "cpu"), ("silent", "1"),
                 ("eval_train", "0"), ("dtype", "bfloat16")] + keys:
        tb.set_param(k, v)
    tb.load_model(path)
    tb._ensure_opt_state()
    for key, group in jb.opt_state.items():
        for tag, st in group.items():
            assert tb.params[key][tag].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tb.opt_state[key][tag]["w32"].numpy(), np.asarray(st["w32"]))


def _cli_conf(body, tmp_path, name, model_in, extra):
    """A train conf: the net and its weights come from ``model_in`` (a
    netconfig block here would re-apply its layer keys globally)."""
    return (f"dev = cpu\ntask = train\nmodel_in = {model_in}\n"
            f"model_dir = {tmp_path}/{name}\nsave_model = 1\nsilent = 1\n"
            f"{body}\n" + "".join(f"{k} = {v}\n" for k, v in extra))


def test_cli_synth_device_data_matches_jax_cli(jopts, tmp_path):
    """``synth_device_data = 1 multi_step = 2`` on the narrow AlexNet
    under the slice's options through both CLIs, from one JAX-written
    0000.model: both draw the same batches from RandomState(0), so after
    two sgd-momentum steps their 0001.model params agree within 1e-5."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils import serializer
    net = _alexnet_narrow()
    jt, _ = _cnn_pair(net, 4, _SGD_KEYS)
    init = str(tmp_path / "0000.model")
    jt.save_model(init)
    extra = ([("batch_size", "4"), ("num_round", "1"),
              ("synth_device_data", "1"), ("multi_step", "2")]
             + _SGD_KEYS + list(SLICE_OPTS))
    for name, task in (("jax", JTask), ("port", TTask)):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(_cli_conf("", tmp_path, name, init, extra))
        t = task()
        assert t.run([str(conf)]) == 0
    assert len(t.last_train["losses"]) == 2
    _, want, _, _ = serializer.load_model(str(tmp_path / "jax/0001.model"))
    _, got, _, _ = serializer.load_model(str(tmp_path / "port/0001.model"))
    for key, group in want.items():
        for tag, v in group.items():
            np.testing.assert_allclose(got[key][tag], v, atol=1e-5,
                                       err_msg=f"{key}/{tag}")


def test_cli_mnist_conv_round_matches_jax_cli(jopts, tmp_path, capsys):
    """MNIST_CONV.conf under ``pool_layout = hwcn fast_wgrad = hwcn`` for
    one round over tools/make_synth_mnist.py data (shuffled train
    iterator, ``eval = test``, ``metric = error``, ``eval_train = 1``),
    both CLIs from one JAX-written 0000.model: the round's
    ``[1]\\ttrain-error:..\\ttest-error:..`` lines are equal.  Dropout's
    threshold is set to 0 in both: the packages' random streams
    differ."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    subprocess.run([sys.executable, os.path.join(REPO,
                                                 "tools/make_synth_mnist.py"),
                    "--out", str(tmp_path / "data"), "--train", "800",
                    "--test", "300"], check=True, capture_output=True)
    text = open(os.path.join(REPO, "example/MNIST/MNIST_CONV.conf")).read()
    text = text.replace("./data/", f"{tmp_path}/data/").replace(
        "threshold = 0.5", "threshold = 0.0")
    text = re.sub(r"(?m)^(dev|save_model|model_dir|max_round|num_round)"
                  r"\s*=.*$", "", text)
    a, b = text.index("netconfig=start"), text.index("netconfig=end") + 13
    net, text = text[a:b] + "\ninput_shape = 1,28,28\n", text[:a] + text[b:]
    jt, _ = _cnn_pair(net, 100, [("random_type", "gaussian")])
    init = str(tmp_path / "0000.model")
    jt.save_model(init)
    extra = [("num_round", "1"), ("pool_layout", "hwcn"),
             ("fast_wgrad", "hwcn")]
    lines = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(_cli_conf(text, tmp_path, name, init, extra))
        capsys.readouterr()
        t = task()
        assert t.run([str(conf)]) == 0
        lines[name] = [ln for ln in capsys.readouterr().err.splitlines()
                       if ln.startswith("[1]")]
    assert len(lines["port"]) == 1 and "test-error:" in lines["port"][0]
    assert lines["port"] == lines["jax"]
    # the round's values, as the port's task keeps them
    [evals] = t.last_train["evals"]
    assert lines["port"][0] == "[1]" + "".join(
        f"\t{k}:{v:f}" for k, v in evals.items())


# ------------------------------------------------- engine, registry, io

def test_engine_values_ported_and_refused():
    """The slices' values are accepted (pallas_lrn = hwcn: row 2,
    fast_wgrad = pallas: row 6, fused_update = 1: row 13 among them), and
    every value of the CNN stack's lowering options (pool_bwd = auto,
    pool_layout = chwn, group_conv = split, conv1_fwd = s2d, relu_vjp =
    xla, conv_sibling_fuse = 1, concat_virtual = 1), and the dp_*
    options, refused by name until the data-parallel plane was ported."""
    opts = EngineOptions()
    for k, v in SLICE_OPTS + (("pool_bwd", "gather"), ("pool_bwd", "eq"),
                              ("pallas_lrn", "bandconv"),
                              ("pallas_lrn", "0"), ("fast_wgrad", "off"),
                              ("pool_relu_reorder", "0"),
                              ("pallas_lrn", "hwcn"),
                              ("fast_wgrad", "pallas"),
                              ("fused_update", "1"),
                              ("relu_vjp", "xla"), ("conv_sibling_fuse", "1"),
                              ("pool_bwd", "auto"), ("pool_layout", "chwn"),
                              ("group_conv", "split"), ("conv1_fwd", "s2d"),
                              ("concat_virtual", "1")):
        opts.set(k, v)
        assert getattr(opts, k) == v
    for k, v in (("dp_overlap", "1"), ("dp_reduce_dtype", "bf16"),
                 ("dp_reduce_at", "step"), ("dp_bucket_mb", "8")):
        opts.set(k, v)
        assert getattr(opts, k) == v


def test_every_jax_layer_is_registered_or_refused_by_name():
    from cxxnet_tpu.layers.registry import layer_type_names as jnames
    from cxxnet_tpu_torch.layers.registry import (create_layer,
                                                  layer_type_names)
    ported = set(layer_type_names())
    for name in jnames():
        if name in ported:
            assert create_layer(name).type_names
        else:
            with pytest.raises(ValueError, match="not ported"):
                create_layer(name)
    assert {"conv", "max_pooling", "relu_max_pooling", "sum_pooling",
            "avg_pooling", "lrn", "fullc", "flatten", "dropout", "relu",
            "sigmoid", "tanh", "softplus", "softmax", "l2_loss",
            "multi_logistic"} <= ported


def test_zoo_matches_jax():
    from cxxnet_tpu.models import alexnet as jalexnet
    from cxxnet_tpu.models import lenet as jlenet
    from cxxnet_tpu_torch.models import alexnet, lenet
    assert alexnet() == jalexnet() and alexnet(10) == jalexnet(10)
    assert lenet() == jlenet()


@pytest.mark.parametrize("extra", [
    [("input_flat", "0"), ("shuffle", "1")],
    [("input_flat", "1")],
    [("input_flat", "0"), ("round_batch", "1")],
])
def test_mnist_iterator_batches_match_jax(tmp_path, extra):
    """iter = mnist: every batch of an epoch (data, label, index,
    padding counts) bitwise equal to the JAX package's, the padded tail
    included."""
    from cxxnet_tpu.io.factory import create_iterator as jcreate
    from cxxnet_tpu.io.factory import init_iterator as jinit
    from cxxnet_tpu_torch.io.factory import create_iterator as tcreate
    from cxxnet_tpu_torch.io.factory import init_iterator as tinit
    subprocess.run([sys.executable, os.path.join(REPO,
                                                 "tools/make_synth_mnist.py"),
                    "--out", str(tmp_path), "--train", "70", "--test", "10"],
                   check=True, capture_output=True)
    cfg = [("iter", "mnist"),
           ("path_img", str(tmp_path / "train-images-idx3-ubyte.gz")),
           ("path_label", str(tmp_path / "train-labels-idx1-ubyte.gz"))] \
        + extra + [("iter", "end")]
    defcfg = [("batch_size", "16"), ("silent", "1")]
    its = [jinit(jcreate(cfg), defcfg), tinit(tcreate(cfg), defcfg)]
    for it in its:
        it.before_first()
    n = 0
    while True:
        a, b = its[0].next(), its[1].next()
        if a is None:
            assert b is None
            break
        n += 1
        for f in ("data", "label", "index", "num_batch_padd",
                  "tail_mask_padd"):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f)
    assert n == 5


def test_metrics_match_jax():
    """error, rec@1, rec@3, rmse and logloss over the same scores
    (with tied scores for rec@n's seeded tie-break): the same values and
    the same printed line."""
    from cxxnet_tpu.utils.metric import MetricSet as JSet
    from cxxnet_tpu_torch.utils.metric import MetricSet as TSet
    rnd = np.random.RandomState(9)
    sets = [JSet(), TSet()]
    for s in sets:
        for m in ("error", "rec@1", "rec@3", "logloss"):
            s.add_metric(m, "label")
    for _ in range(3):
        p = np.round(rnd.rand(16, 5), 1)
        p = p / p.sum(axis=1, keepdims=True).clip(1e-3)
        lab = {"label": rnd.randint(0, 5, (16, 1)).astype(np.float32)}
        for s in sets:
            s.add_eval([p] * 4, lab)
    assert sets[1].print_line("test") == sets[0].print_line("test")
    assert sets[1].values("test") == sets[0].values("test")
    js, ts = JSet(), TSet()
    for s in (js, ts):
        s.add_metric("rmse", "label")
        s.add_eval([np.arange(6.0).reshape(3, 2)],
                   {"label": np.ones((3, 2))})
    assert ts.print_line("train") == js.print_line("train")

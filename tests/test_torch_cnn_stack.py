"""The rest of the port's CNN stack against the JAX package, on the CPU:
the layers, lowering keys, trainer keys and zoo builders that GoogLeNet
and ResNet need (cxxnet_tpu_torch/layers, ops/nn.py, nnet/net.py,
nnet/trainer.py, nnet/pipeline_net.py, models/zoo.py).

Inputs are made with numpy from a seed and handed to both sides.
Tolerances (max |diff| / max |ref|), as tests/test_torch_cnn.py holds
the first CNN slice:

* a layer's forward 1e-6 and its gradients 1e-5 (one function, sums in
  another order);
* a whole net's gradients after one step 5e-3, the f32 grad envelope;
* max pools bitwise: the cotangents are multiples of 1/8, so every sum
  of window gradients is exact whatever its order.

The random streams differ (threefry against Philox), so dropout runs at
threshold 0 in the parity tests, and the uniform draws of insanity,
prelu and insanity pooling are injected into both packages.
"""

import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.ops import nn as JN  # noqa: E402
from cxxnet_tpu_torch.io.data import DataBatch  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import (NetTrainer,  # noqa: E402
                                           params_from_jax)
from cxxnet_tpu_torch.ops import nn as TN  # noqa: E402
from cxxnet_tpu_torch.utils.config import parse_config_string  # noqa: E402
from test_torch_cnn import _dyadic, _rel, _t, _topts, jopts  # noqa: E402,F401

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
NET_GRAD_TOL = 5e-3


# --------------------------------------------------------------- layers

def _layer_pair(type_name, cfg, xs, params, buffers, g, pairs, jopts,
                train=True, mask=None, epoch=0):
    """One layer of each package on inputs ``xs`` with the same params and
    buffers, output gradient ``g``: ((y, dxs, dparams, new buffers) of
    the JAX layer, the same of the port's)."""
    from cxxnet_tpu.layers.base import ForwardContext as JCtx
    from cxxnet_tpu.layers.base import LabelInfo as JLabels
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx
    from cxxnet_tpu_torch.layers.base import LabelInfo as TLabels
    from cxxnet_tpu_torch.layers.registry import create_layer as tcreate
    jl, tl = jcreate(type_name), tcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
        tl.set_param(k, v)
    shapes = [x.shape for x in xs]
    assert jl.infer_shapes(shapes) == tl.infer_shapes(shapes)
    for k, v in pairs:
        jopts.set(k, v)
    tags = sorted(params)
    nx = len(xs)
    jb = {k: jnp.asarray(v) for k, v in buffers.items()}
    jlab = None if mask is None else JLabels(fields={},
                                             mask=jnp.asarray(mask))
    newb = {}

    def jf(*args):
        ctx = JCtx(train=train, rng=jax.random.PRNGKey(0), labels=jlab,
                   epoch=epoch)
        outs, nb = jl.forward(dict(zip(tags, args[nx:])), jb,
                              list(args[:nx]), ctx)
        newb.update(nb)
        return outs[0]

    y_j, vjp = jax.vjp(jf, *[jnp.asarray(x) for x in xs],
                       *[jnp.asarray(params[t]) for t in tags])
    dj = vjp(jnp.asarray(g))
    jnewb = {k: np.asarray(v) for k, v in newb.items()}
    xt = [_t(x).requires_grad_() for x in xs]
    pt = {t: _t(params[t]).requires_grad_() for t in tags}
    bt = {k: _t(v) for k, v in buffers.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    tlab = None if mask is None else TLabels(mask=_t(mask))
    ctx = TCtx(train=train, opts=_topts(pairs), rng=gen, labels=tlab,
               epoch=epoch)
    outs, tnewb = tl.forward_buffers(pt, bt, xt, ctx)
    wrt = xt + [pt[t] for t in tags]
    dt = torch.autograd.grad(outs[0], wrt, _t(g), allow_unused=True)
    dt = [torch.zeros_like(w) if d is None else d for d, w in zip(dt, wrt)]
    return ((np.asarray(y_j), [np.asarray(d) for d in dj[:nx]],
             {t: np.asarray(d) for t, d in zip(tags, dj[nx:])}, jnewb),
            (outs[0].detach().numpy(), [d.numpy() for d in dt[:nx]],
             {t: d.numpy() for t, d in zip(tags, dt[nx:])},
             {k: v.numpy() for k, v in tnewb.items()}))


def _grid(rnd, shape, step=0.5):
    """Values on a grid of ``step`` (many ties), about half of them 0
    after a relu."""
    return (np.round(rnd.randn(*shape) * 1.5) * step).astype(np.float32)


def _fixconn_file(tmp_path, nrow, ncol, rnd):
    cells = [(r, c) for r in range(nrow) for c in range(ncol)
             if rnd.rand() < 0.4]
    path = tmp_path / "fix.txt"
    path.write_text(f"{nrow} {ncol} {len(cells)}\n" + "".join(
        f"{r} {c} {rnd.randn():.6f}\n" for r, c in cells))
    return str(path)


def _bn_inputs(rnd, shape):
    ax = 3 if shape[1] == 1 else 1
    c = shape[ax]
    return ({"wmat": (1 + 0.3 * rnd.randn(c)).astype(np.float32),
             "bias": rnd.randn(c).astype(np.float32)},
            {"moving_mean": rnd.randn(c).astype(np.float32),
             "moving_var": (1 + rnd.rand(c)).astype(np.float32)})


#: name -> (type, config, input shapes, params maker, train, mask)
_LAYERS = {
    "concat": ("concat", [], [(2, 1, 1, 5), (2, 1, 1, 3), (2, 1, 1, 4)]),
    "ch_concat": ("ch_concat", [], [(2, 3, 4, 4), (2, 2, 4, 4),
                                    (2, 1, 4, 4), (2, 4, 4, 4)]),
    "maxout_ties": ("maxout", [("ngroup", "2")], [(2, 6, 3, 3)]),
    "xelu": ("xelu", [("b", "3")], [(2, 3, 4, 5)]),
    "insanity_eval": ("insanity", [("lb", "3"), ("ub", "7")],
                      [(2, 3, 4, 5)]),
    "insanity_fixed_divisor": ("insanity", [("lb", "4"), ("ub", "4")],
                               [(2, 3, 4, 5)]),
    "prelu_conv": ("prelu", [], [(2, 3, 4, 5)]),
    "prelu_flat": ("prelu", [], [(3, 1, 1, 7)]),
    "bias": ("bias", [], [(3, 1, 1, 7)]),
    "fixconn": ("fixconn", [("nhidden", "5")], [(3, 1, 1, 6)]),
    "batch_norm_conv": ("batch_norm", [], [(4, 3, 5, 5)]),
    "batch_norm_flat": ("batch_norm", [("eps", "1e-5")], [(6, 1, 1, 7)]),
    "batch_norm_masked": ("batch_norm", [], [(4, 3, 5, 5)]),
    "batch_norm_eval_batch_stats": ("batch_norm", [], [(4, 3, 5, 5)]),
    "batch_norm_eval_moving": ("batch_norm", [("moving_average", "1")],
                               [(4, 3, 5, 5)]),
    "batch_norm_momentum": ("batch_norm", [("bn_momentum", "0.5")],
                            [(4, 1, 1, 6)]),
    "insanity_max_pooling_eval": ("insanity_max_pooling",
                                  [("kernel_size", "3"), ("stride", "2")],
                                  [(2, 3, 9, 9)]),
    "insanity_max_pooling_keep_1": ("insanity_max_pooling",
                                    [("kernel_size", "3"), ("stride", "2")],
                                    [(2, 3, 9, 9)]),
}


@pytest.mark.parametrize("case", sorted(_LAYERS))
def test_new_layer_matches_jax(case, jopts, tmp_path, monkeypatch):
    """Each layer the slice registers against the JAX layer of the same
    type and config, with the same params and buffers: output FWD_TOL,
    every input and param gradient GRAD_TOL, new buffers FWD_TOL; pools
    bitwise (maxout's tied maxima share the gradient evenly in both).
    Training forwards unless the case says eval; batch_norm also with a
    tail-batch mask (two padding rows out of the statistics) and at eval,
    by batch statistics (the reference's default) or by the moving
    ones."""
    type_name, cfg, shapes = _LAYERS[case]
    rnd = np.random.RandomState(11)
    # no case's result depends on its draws (insanity's range is one
    # point, insanity pooling keeps every read): numpy ones cost no
    # threefry compile
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, s, dtype=jnp.float32, **kw:
                        jnp.asarray(rnd.rand(*s), dtype))
    xs = [_grid(rnd, s) if "pool" in case or "maxout" in case
          else rnd.randn(*s).astype(np.float32) for s in shapes]
    params, buffers, mask = {}, {}, None
    train = "eval" not in case
    if type_name == "prelu":
        ax = 3 if shapes[0][1] == 1 else 1
        params = {"bias": rnd.uniform(-0.2, 1.2, shapes[0][ax])
                  .astype(np.float32)}
    elif type_name == "bias":
        params = {"bias": rnd.randn(shapes[0][3]).astype(np.float32)}
    elif type_name == "fixconn":
        cfg = cfg + [("fixconn_weight", _fixconn_file(tmp_path, 5, 6, rnd))]
        from cxxnet_tpu_torch.layers.fullc import FixConnectLayer
        layer = FixConnectLayer()
        for k, v in cfg:
            layer.set_param(k, v)
        buffers = {"wmat": layer.init_buffers(shapes, "cpu")["wmat"]
                   .numpy()}
    elif type_name == "batch_norm":
        params, buffers = _bn_inputs(rnd, shapes[0])
        if "masked" in case:
            mask = np.array([1, 1, 0, 0], np.float32)
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    jl = jcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
    g = _dyadic(rnd, jl.infer_shapes(shapes)[0])
    (yj, dxj, dpj, bj), (yt, dxt, dpt, bt) = _layer_pair(
        type_name, cfg, xs, params, buffers, g, (), jopts, train=train,
        mask=mask)
    if "pool" in case:
        np.testing.assert_array_equal(yt, yj)
        for a, b in zip(dxt, dxj):
            np.testing.assert_array_equal(a, b)
    else:
        assert _rel(yt, yj) <= FWD_TOL
        for a, b in zip(dxt, dxj):
            assert _rel(a, b) <= GRAD_TOL
    assert set(dpt) == set(dpj)
    for tag in dpj:
        assert _rel(dpt[tag], dpj[tag]) <= GRAD_TOL, tag
    assert set(bt) == set(bj)
    for k in bj:
        assert _rel(bt[k], bj[k]) <= FWD_TOL, k
    if type_name == "batch_norm" and train:
        assert not np.allclose(bt["moving_mean"], buffers["moving_mean"])


@pytest.mark.parametrize("case", ["insanity_annealed", "prelu_noise",
                                  "insanity_max_pooling_keep_0.6"])
def test_random_layers_with_injected_draws_match_jax(case, jopts,
                                                     monkeypatch):
    """The layers whose training forward draws uniforms (insanity's
    divisors, halfway through its annealing; prelu's slope noise;
    insanity pooling's neighbour redirect, which sends 40% of the reads
    to a neighbour), with the same draws injected into both packages:
    as test_new_layer_matches_jax, pools bitwise."""
    rnd = np.random.RandomState(12)
    shape = (2, 3, 9, 9)
    x = _grid(rnd, shape)
    draws = rnd.rand(*shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, s, dtype=jnp.float32, **kw:
                        jnp.asarray(draws).reshape(s).astype(dtype))
    monkeypatch.setattr(TN, "uniform", lambda gen, s, dtype:
                        torch.from_numpy(draws).reshape(s).to(dtype))
    params, epoch = {}, 0
    if case == "insanity_annealed":
        type_name, epoch = "insanity", 2
        cfg = [("lb", "2"), ("ub", "6"), ("calm_start", "0"),
               ("calm_end", "4")]
        x = rnd.randn(*shape).astype(np.float32)
    elif case == "prelu_noise":
        type_name, cfg = "prelu", [("random", "0.3")]
        params = {"bias": rnd.uniform(0, 1, 3).astype(np.float32)}
        x = rnd.randn(*shape).astype(np.float32)
    else:
        type_name = "insanity_max_pooling"
        cfg = [("kernel_size", "3"), ("stride", "2"), ("keep", "0.6")]
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    jl = jcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
    g = _dyadic(rnd, jl.infer_shapes([shape])[0])
    (yj, dxj, dpj, _), (yt, dxt, dpt, _) = _layer_pair(
        type_name, cfg, [x], params, {}, g, (), jopts, epoch=epoch)
    if "pool" in case:
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(dxt[0], dxj[0])
        assert not np.array_equal(yt, TN.max_pool2d(
            _t(x), 3, 3, 2, opts=_topts()).numpy())
    else:
        assert _rel(yt, yj) <= FWD_TOL
        assert _rel(dxt[0], dxj[0]) <= GRAD_TOL
    for tag in dpj:
        assert _rel(dpt[tag], dpj[tag]) <= GRAD_TOL, tag


# ------------------------------------------------------- lowering keys

#: name -> (layer type, config, input shape, engine option, value)
_LOWERINGS = {
    "space_to_depth": ("conv", [("kernel_size", "5"), ("stride", "2"),
                                ("pad", "1"), ("nchannel", "6"),
                                ("space_to_depth", "1")], (2, 4, 13, 13),
                       None, None),
    "group_conv_split": ("conv", [("kernel_size", "3"), ("nchannel", "6"),
                                  ("ngroup", "3"), ("pad", "1")],
                         (2, 6, 7, 7), "group_conv", "split"),
    "relu_vjp_xla": ("relu", [], (2, 3, 6, 6), "relu_vjp", "xla"),
    "pool_layout_chwn": ("max_pooling", [("kernel_size", "3"),
                                         ("stride", "1"), ("pad", "1")],
                         (2, 3, 7, 7), "pool_layout", "chwn"),
    "pool_bwd_auto": ("max_pooling", [("kernel_size", "3"),
                                      ("stride", "2")], (2, 3, 9, 9),
                      "pool_bwd", "auto"),
}


@pytest.mark.parametrize("case", sorted(_LOWERINGS))
def test_lowering_key_matches_jax_and_key_off(case, jopts):
    """Each layer-level lowering key against the JAX layer under the same
    key (forward FWD_TOL, gradients GRAD_TOL; pools bitwise) and against
    the port with the key off, the same math (NET_GRAD_TOL).  relu_vjp =
    xla halves the gradient where x == 0 in both packages, so its input
    holds exact zeros against the JAX package and none against the key
    off.  On the CPU pool_bwd = auto is the one-winner pool, as the JAX
    package's is off the TPU."""
    type_name, cfg, shape, key, val = _LOWERINGS[case]
    rnd = np.random.RandomState(13)
    x = (_grid(rnd, shape) if type_name != "conv"
         else rnd.randn(*shape).astype(np.float32))
    params = {}
    if type_name == "conv":
        d = dict(cfg)
        co, k = int(d["nchannel"]), int(d["kernel_size"])
        ci = shape[1] // int(d.get("ngroup", "1"))
        params = {"wmat": (rnd.randn(co, ci, k, k) * 0.2).astype(np.float32),
                  "bias": rnd.randn(co).astype(np.float32)}
    pairs = () if key is None else ((key, val),)
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    jl = jcreate(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
    g = _dyadic(rnd, jl.infer_shapes([shape])[0])
    (yj, dxj, dpj, _), (yt, dxt, dpt, _) = _layer_pair(
        type_name, cfg, [x], params, {}, g, pairs, jopts)
    if type_name == "max_pooling":
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(dxt[0], dxj[0])
    else:
        assert _rel(yt, yj) <= FWD_TOL
        assert _rel(dxt[0], dxj[0]) <= GRAD_TOL
    for tag in dpj:
        assert _rel(dpt[tag], dpj[tag]) <= GRAD_TOL, tag
    if case == "relu_vjp_xla":
        assert (x == 0).any() and not np.array_equal(
            dxt[0], np.where(x > 0, g, 0))
        x = rnd.randn(*shape).astype(np.float32)
    off_cfg = [(k, v) for k, v in cfg if k != "space_to_depth"]
    (_, _, _, _), (y0, dx0, dp0, _) = _layer_pair(
        type_name, off_cfg, [x], params, {}, g, (), jopts)
    (_, _, _, _), (y1, dx1, dp1, _) = _layer_pair(
        type_name, cfg, [x], params, {}, g, pairs, jopts)
    assert _rel(y1, y0) <= FWD_TOL
    assert _rel(dx1[0], dx0[0]) <= NET_GRAD_TOL
    for tag in dp0:
        assert _rel(dp1[tag], dp0[tag]) <= NET_GRAD_TOL, tag


def test_conv1_fwd_s2d_matches_jax_conv_bias_fast(jopts):
    """``conv1_fwd = s2d``: the fast-wgrad conv's forward through the
    space-to-depth identity (the JAX package takes it only on the TPU, so
    its ``conv_bias_fast`` is called directly) against the JAX function
    under the same key and against the port's plain forward."""
    from cxxnet_tpu_torch.ops.conv_wgrad import conv_bias_fast
    rnd = np.random.RandomState(14)
    x = rnd.randn(2, 3, 23, 23).astype(np.float32)
    w = (rnd.randn(8, 3, 7, 7) * 0.1).astype(np.float32)
    b = rnd.randn(8).astype(np.float32)
    jopts.set("conv1_fwd", "s2d")
    jopts.set("fast_wgrad", "s2d")
    y_j, vjp = jax.vjp(lambda xv, wv, bv: JN.conv_bias_fast(xv, wv, bv, 2,
                                                             3, 3),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = _dyadic(rnd, y_j.shape)
    dj = vjp(jnp.asarray(g))
    outs = {}
    for fwd_s2d in (True, False):
        xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
        y = conv_bias_fast(xt, wt, bt, 2, 3, 3, "s2d", fwd_s2d)
        outs[fwd_s2d] = [y.detach().numpy()] + [
            d.numpy() for d in torch.autograd.grad(y, (xt, wt, bt), _t(g))]
    for got, want in zip(outs[True], [np.asarray(y_j)] + [np.asarray(d)
                                                          for d in dj]):
        assert _rel(got, want) <= GRAD_TOL
    for got, want in zip(outs[True], outs[False]):
        assert _rel(got, want) <= GRAD_TOL


# ----------------------------------------------- tied windows (item 0)

def test_relu_fused_pool_gate_matches_jax_on_tied_windows(jopts):
    """``pool_layout = nchw pool_bwd = sas pool_relu_fuse = 1`` on relu'd
    inputs on a grid (whole windows tie, at zero and above): the JAX
    package fuses the relu into its all-ties pool only where its gate
    holds (TPU, no padding, a batch of whole 128-image tiles); elsewhere
    its gradient is the one-winner pool's.  The port's input gradient
    must equal it bitwise at a padded pool (k3 s1 p1, an inception
    pool) and at a batch of 6 (k3 s2, pool1)."""
    rnd = np.random.RandomState(15)
    pairs = (("pool_layout", "nchw"), ("pool_bwd", "sas"),
             ("pool_relu_fuse", "1"))
    for cfg, shape in (([("kernel_size", "3"), ("stride", "1"),
                         ("pad", "1")], (2, 4, 8, 8)),
                       ([("kernel_size", "3"), ("stride", "2")],
                        (6, 3, 11, 11))):
        x = np.maximum(_grid(rnd, shape), 0)
        from cxxnet_tpu.layers.registry import create_layer as jcreate
        jl = jcreate("relu_max_pooling")
        for k, v in cfg:
            jl.set_param(k, v)
        g = _dyadic(rnd, jl.infer_shapes([shape])[0])
        (yj, dxj, _, _), (yt, dxt, _, _) = _layer_pair(
            "relu_max_pooling", cfg, [x], {}, {}, g, pairs, jopts)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(dxt[0], dxj[0])


@pytest.mark.parametrize("shape,geom", [
    ((128, 64, 112, 112), (3, 3, 2, 0, 0)),
    ((256, 192, 56, 56), (3, 3, 2, 0, 0)),
    ((128, 256, 28, 28), (3, 3, 1, 1, 1)),
    ((130, 64, 112, 112), (3, 3, 2, 0, 0)),
    ((128, 64, 224, 224), (2, 2, 2, 0, 0)),
    ((128, 64, 112, 112), (2, 3, 2, 0, 0)),
    ((128, 832, 14, 14), (3, 3, 2, 0, 0)),
    ((256, 96, 55, 55), (3, 3, 2, 0, 0)),
])
def test_pool_gate_matches_jax_on_the_tpu(monkeypatch, shape, geom):
    """The shape half of the port's pool gate equals the JAX package's
    gate read as on the TPU (its backend patched in this process): at
    GoogLeNet's and AlexNet's pools, a padded one, a batch of 130, a
    non-square window and a plane past the backward's budget."""
    monkeypatch.setattr(JN.jax, "default_backend", lambda: "tpu")
    want = JN._hwcn_pool_ok(types.SimpleNamespace(shape=shape), *geom)
    assert TN.hwcn_pool_fits(shape, *geom) == want
    assert not TN.hwcn_pool_ok(torch.empty((0,) + shape[1:]), *geom)


@pytest.mark.parametrize("layout", ["nchw", "chwn", "hwcn"])
@pytest.mark.parametrize("bwd", ["sas", "eq", "gather", "auto"])
@pytest.mark.parametrize("fuse", ["0", "1"])
def test_inception_pools_bitwise_under_every_pool_option(jopts, layout,
                                                         bwd, fuse):
    """GoogLeNet's pools on relu'd, tied inputs under every pool_layout /
    pool_bwd / pool_relu_fuse value, bitwise against the JAX package:
    an inception pool (max_pooling k3 s1 p1 on a concat of relu
    outputs) and a trunk pool with its relu deferred (relu_max_pooling
    k3 s2).  Under sas the one-winner choice, the -inf padding's
    included, is XLA select-and-scatter's."""
    rnd = np.random.RandomState(16)
    pairs = (("pool_layout", layout), ("pool_bwd", bwd),
             ("pool_relu_fuse", fuse))
    for type_name, cfg, shape in (
            ("max_pooling", [("kernel_size", "3"), ("stride", "1"),
                             ("pad", "1")], (2, 5, 7, 7)),
            ("relu_max_pooling", [("kernel_size", "3"), ("stride", "2")],
             (2, 4, 9, 9))):
        x = np.maximum(_grid(rnd, shape), 0)
        if type_name == "relu_max_pooling":
            x = _grid(rnd, shape)
        from cxxnet_tpu.layers.registry import create_layer as jcreate
        jl = jcreate(type_name)
        for k, v in cfg:
            jl.set_param(k, v)
        g = _dyadic(rnd, jl.infer_shapes([shape])[0])
        (yj, dxj, _, _), (yt, dxt, _, _) = _layer_pair(
            type_name, cfg, [x], {}, {}, g, pairs, jopts)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(dxt[0], dxj[0])


# ------------------------------------------------------------- the nets

@pytest.fixture
def numpy_init(monkeypatch):
    """The JAX package's weight init drawn with numpy (the same
    distributions, seeded by the weight's shape): its threefry draws
    compile once a weight shape, ~1 s each on the CPU.  Both packages
    then start from these weights."""
    from cxxnet_tpu.layers.base import LayerParam

    def rand_init_weight(self, key, shape, in_num, out_num,
                         dtype=jnp.float32):
        rnd = np.random.RandomState(sum(shape) * 7919 + len(shape))
        if self.random_type == 1:
            a = (self.init_uniform if self.init_uniform > 0
                 else float(np.sqrt(3.0 / (in_num + out_num))))
            w = rnd.uniform(-a, a, shape)
        else:
            sigma = (float(np.sqrt(2.0 / in_num)) if self.random_type == 2
                     else self.init_sigma)
            w = rnd.randn(*shape) * sigma
        return jnp.asarray(w, dtype)

    monkeypatch.setattr(LayerParam, "rand_init_weight", rand_init_weight)


def _conv_relu(lines, bottom, top, name, nc, k, pad=0, stride=1):
    lines += [f"layer[{bottom}->{top}] = conv:{name}",
              f"  kernel_size = {k}", f"  nchannel = {nc}",
              "  random_type = xavier"]
    if stride != 1:
        lines.append(f"  stride = {stride}")
    if pad:
        lines.append(f"  pad = {pad}")
    lines.append("layer[+0] = relu")


def _inception(lines, name, bottom, widths):
    """An inception module written as GoogLeNet.conf writes it: the four
    branches read the bottom node directly, each conv with a ``layer[+0]
    = relu`` self-loop."""
    n1, r3, n3, r5, n5, proj = widths
    _conv_relu(lines, bottom, f"{name}_b1", f"{name}_1x1", n1, 1)
    _conv_relu(lines, bottom, f"{name}_3r", f"{name}_3x3r", r3, 1)
    _conv_relu(lines, f"{name}_3r", f"{name}_b2", f"{name}_3x3", n3, 3, 1)
    _conv_relu(lines, bottom, f"{name}_5r", f"{name}_5x5r", r5, 1)
    _conv_relu(lines, f"{name}_5r", f"{name}_b3", f"{name}_5x5", n5, 5, 2)
    lines += [f"layer[{bottom}->{name}_pool] = max_pooling",
              "  kernel_size = 3", "  stride = 1", "  pad = 1"]
    _conv_relu(lines, f"{name}_pool", f"{name}_b4", f"{name}_proj", proj, 1)
    lines.append(f"layer[{name}_b1,{name}_b2,{name}_b3,{name}_b4->"
                 f"{name}_out] = ch_concat")
    return f"{name}_out"


def inception_narrow(dropout: float = 0.0, body_dropout: float = 0.0,
                     modules: int = 2) -> str:
    """GoogLeNet.conf's layer sequence cut to ``modules`` inception
    modules, at channels 2-12 and input 3 x 32 x 32: conv1 k7 s2 p3, pool, LRN,
    conv2r / conv2, LRN, pool, inception 3a and 3b (ch_concat of four
    branches, a padded k3 s1 pool among them), pool, average pool,
    flatten, dropout, fullc, softmax.  ``body_dropout`` adds a dropout
    self-loop on pool2's node, inside the body."""
    lines = ["netconfig=start"]
    _conv_relu(lines, "0", "c1", "conv1", 8, 7, 3, 2)
    lines += ["layer[c1->p1] = max_pooling", "  kernel_size = 3",
              "  stride = 2", "layer[p1->n1] = lrn", "  local_size = 5"]
    _conv_relu(lines, "n1", "c2r", "conv2r", 8, 1)
    _conv_relu(lines, "c2r", "c2", "conv2", 12, 3, 1)
    lines += ["layer[c2->n2] = lrn", "  local_size = 5",
              "layer[n2->p2] = max_pooling", "  kernel_size = 3",
              "  stride = 2"]
    if body_dropout:
        lines += ["layer[p2->p2] = dropout", f"  threshold = {body_dropout}"]
    top = _inception(lines, "i3a", "p2", (4, 4, 6, 2, 3, 3))
    if modules > 1:
        top = _inception(lines, "i3b", top, (6, 4, 6, 2, 4, 4))
    lines += [f"layer[{top}->p3] = max_pooling", "  kernel_size = 3",
              "  stride = 2", "layer[p3->gp] = avg_pooling",
              "  kernel_size = 2", "  stride = 1",
              "layer[gp->fl] = flatten", "layer[fl->fl] = dropout",
              f"  threshold = {dropout}", "layer[fl->fc] = fullc:loss_fc",
              "  nhidden = 10", "layer[fc->fc] = softmax", "netconfig=end",
              "input_shape = 3,32,32"]
    return "\n".join(lines) + "\n"


#: GoogLeNet.conf's lowering keys, as shipped
GOOGLENET_KEYS = (("input_s2d", "1"), ("conv_sibling_fuse", "1"),
                  ("pallas_lrn", "bandconv"), ("concat_virtual", "1"),
                  ("batch_split", "2"))
_SGD = [("updater", "sgd"), ("momentum", "0.9"), ("wmat:lr", "0.01"),
        ("wmat:wd", "0.0002"), ("bias:wd", "0.000")]


def _port_trainer(net, batch, keys, seed=0):
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in [("batch_size", str(batch)), ("dev", "cpu"),
                 ("seed", str(seed)), ("eval_train", "0"),
                 ("silent", "1")] + list(keys):
        tt.set_param(k, v)
    tt.init_model()
    return tt


def _jax_step_grads(net, batch, keys, db):
    """A JAX trainer on ``net`` under ``keys`` and its (loss, grads) of
    one step on DataBatch ``db`` (the step jitted; staged as its CLI
    stages a batch)."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(net, batch, "cpu", extra=list(keys) + [
        ("eval_train", "0"), ("silent", "1")])
    data = jt._s2d_transform(jnp.asarray(db.data))
    f = jax.jit(lambda p, b, d, lab: jt._loss_and_grads(
        p, b, d, lab, (), jnp.int32(0), jax.random.PRNGKey(0), ()))
    (loss, _), grads = f(jt.params, jt.buffers, data, jnp.asarray(db.label))
    return jt, float(loss), jax.tree.map(np.asarray, grads)


def _batch(shape, nclass, seed):
    rnd = np.random.RandomState(seed)
    return DataBatch(
        data=rnd.rand(*shape).astype(np.float32),
        label=rnd.randint(0, nclass, (shape[0], 1)).astype(np.float32),
        index=np.arange(shape[0], dtype=np.uint32))


def _assert_grads(got, want, tol, what=""):
    assert set(got) == set(want)
    for key, group in want.items():
        for tag, g in group.items():
            err = _rel(np.asarray(got[key][tag]), np.asarray(g))
            assert err <= tol, (what, key, tag, err)


def test_inception_narrow_step_under_googlenet_keys_matches_jax(jopts, numpy_init):
    """The narrow two-module inception net under GoogLeNet.conf's keys
    (``input_s2d = 1 conv_sibling_fuse = 1 pallas_lrn = bandconv
    concat_virtual = 1 batch_split = 2``), dropout p = 0, batch 8, from
    one JAX snapshot: the loss within FWD_TOL and every gradient within
    NET_GRAD_TOL of the JAX trainer's under the same keys.  The port
    fused the three 1x1 reduces of each module, staged conv1's input in
    space-to-depth form and moved conv1's bias to pool1."""
    net = inception_narrow()
    db = _batch((8, 3, 32, 32), 10, 21)
    keys = _SGD + list(GOOGLENET_KEYS)
    jt, jloss, jgrads = _jax_step_grads(net, 8, keys, db)
    tt = _port_trainer(net, 8, keys)
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    assert [len(m) for m in tt.net.fuse_groups.values()] == [3, 3]
    assert tt.stage_input(_t(db.data)).shape == (8, 12, 19, 19)
    assert tt.net.connections[0].layer.defer_bias == 1
    loss, grads = tt.loss_and_grads(db)
    assert _rel(float(loss), jloss) <= FWD_TOL
    _assert_grads({k: {t: v.numpy() for t, v in g.items()}
                   for k, g in grads.items()}, jgrads, NET_GRAD_TOL)


@pytest.mark.parametrize("key,val", [("conv_sibling_fuse", "1"),
                                     ("concat_virtual", "1"),
                                     ("input_s2d", "1"),
                                     ("batch_split", "2"),
                                     ("remat", "3")])
def test_net_lowering_key_matches_jax_and_key_off(jopts, numpy_init, key, val):
    """Each net-level lowering key alone on the narrow inception net at
    one module (dropout p = 0), batch 8: the port's gradients within
    NET_GRAD_TOL of the JAX trainer's under the same key, and of the
    port's with the key off (the same math), from one set of weights."""
    net = inception_narrow(modules=1)
    db = _batch((8, 3, 32, 32), 10, 22)
    keys = _SGD + [(key, val)]
    jt, jloss, jgrads = _jax_step_grads(net, 8, keys, db)
    state = params_from_jax(jax.tree.map(np.asarray, jt.params),
                            jax.tree.map(np.asarray, jt.buffers))
    out = {}
    for name, kk in (("on", keys), ("off", _SGD)):
        tt = _port_trainer(net, 8, kk)
        tt.set_state(*state)
        loss, grads = tt.loss_and_grads(db)
        out[name] = (float(loss), {k: {t: v.numpy() for t, v in g.items()}
                                   for k, g in grads.items()})
    assert _rel(out["on"][0], jloss) <= FWD_TOL
    _assert_grads(out["on"][1], jgrads, NET_GRAD_TOL, "jax")
    _assert_grads(out["on"][1], out["off"][1], NET_GRAD_TOL, "off")


def test_remat_matches_remat_0_with_dropout_on(monkeypatch):
    """``remat = 3`` against ``remat = 0`` on the narrow inception net
    with dropout at 0.5 in the head and 0.3 inside the body, from one
    seed: the loss and every gradient equal within FWD_TOL, and the
    trainers' generators end in the same state.  The recompute of each
    checkpointed segment draws its forward's masks again; without that
    replay (``_replaying`` patched out) the body's gradients differ."""
    from cxxnet_tpu_torch.nnet import trainer as T
    net = inception_narrow(dropout=0.5, body_dropout=0.3)
    db = _batch((8, 3, 32, 32), 10, 23)

    def run(keys):
        tt = _port_trainer(net, 8, _SGD + keys, seed=4)
        loss, grads = tt.loss_and_grads(db)
        return float(loss), grads, tt.rng.get_state()

    loss0, ref, state0 = run([])
    loss1, grads, state1 = run([("remat", "3")])
    assert _rel(loss1, loss0) <= FWD_TOL
    _assert_grads(grads, ref, FWD_TOL)
    assert torch.equal(state0, state1)
    monkeypatch.setattr(T, "_replaying", lambda fn, gen: fn)
    _, bad, _ = run([("remat", "3")])
    assert max(_rel(bad[k][t], ref[k][t]) for k in ref for t in ref[k]) > 0.1


def test_partition_network_matches_jax():
    """``partition_network`` (and the frontier each cut carries) equals
    the JAX package's on the GoogLeNet zoo net with its aux heads, at 2,
    3 and 5 segments."""
    from cxxnet_tpu.nnet import pipeline_net as jpn
    from cxxnet_tpu.nnet.net import Network as JNetwork
    from cxxnet_tpu.nnet.netconfig import NetConfig as JNetConfig
    from cxxnet_tpu.utils.config import parse_config_string as jparse
    from cxxnet_tpu_torch.models import googlenet
    from cxxnet_tpu_torch.nnet import pipeline_net as tpn
    from cxxnet_tpu_torch.nnet.net import Network
    from cxxnet_tpu_torch.nnet.netconfig import NetConfig
    text = googlenet(num_class=10)
    jcfg, tcfg = JNetConfig(), NetConfig()
    jcfg.configure(jparse(text))
    tcfg.configure(parse_config_string(text))
    jnet, tnet = JNetwork(jcfg, 2), Network(tcfg, 2)
    for k in (2, 3, 5):
        stages, end = tpn.partition_network(tnet, k)
        assert (stages, end) == jpn.partition_network(jnet, k)
        for lo, _ in stages:
            assert tpn.frontier_nodes(tnet, lo) == jpn.frontier_nodes(jnet,
                                                                      lo)


# ------------------------------------------------------ batch norm, zoo

def _resnet8():
    from cxxnet_tpu_torch.models import resnet
    return resnet(num_class=10, depth=8, widths=(4, 8, 8), input_side=8)


def test_batch_norm_buffers_step_and_cross_both_ways(jopts, numpy_init, tmp_path):
    """A ResNet-8 (zoo, widths 4 / 8 / 8, 3 x 8 x 8) with moving_average
    = 1: one JAX step, its ``.ckpt`` loaded by the port (the buffers
    bitwise), one more step in each package (params and buffers within
    1e-5; the moving statistics moved), the port's ``.model`` loaded by
    the JAX trainer (params and buffers bitwise), and the eval forwards,
    which read the moving statistics, within 1e-5.  batch_split and
    remat refuse the net, as in the JAX package."""
    from __graft_entry__ import _make_trainer
    net = _resnet8()
    keys = _SGD + [("moving_average", "1"), ("eval_train", "0"),
                   ("silent", "1")]
    batches = [_batch((4, 3, 8, 8), 10, s) for s in (31, 32)]
    jt = _make_trainer(net, 4, "cpu", extra=keys)
    init = {k: dict(g) for k, g in jax.tree.map(np.asarray,
                                                jt.buffers).items()}
    jt.update(batches[0])
    from cxxnet_tpu import ckpt as jckpt
    shards, meta = jt.checkpoint_payload()
    path = str(tmp_path / "0001.ckpt")
    jckpt.write_snapshot(path, shards, meta)
    tt = NetTrainer()
    for k, v in [("batch_size", "4"), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.load_model(path)
    for key, group in jt.buffers.items():
        for tag, v in group.items():
            np.testing.assert_array_equal(tt.buffers[key][tag].numpy(),
                                          np.asarray(v))
            assert not np.array_equal(np.asarray(v), init[key][tag])
    jt.update(batches[1])
    tt.update(batches[1])
    for tree, mine in ((jt.params, tt.params), (jt.buffers, tt.buffers)):
        for key, group in tree.items():
            for tag, v in group.items():
                np.testing.assert_allclose(mine[key][tag].numpy(),
                                           np.asarray(v), atol=1e-5,
                                           err_msg=f"{key}/{tag}")
    out = str(tmp_path / "port.model")
    tt.save_model(out)
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    j2 = JTrainer()
    for k, v in [("batch_size", "4"), ("dev", "cpu")] + keys:
        j2.set_param(k, v)
    j2.load_model(out)
    for tree, mine in ((j2.params, tt.params), (j2.buffers, tt.buffers)):
        for key, group in tree.items():
            for tag, v in group.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              mine[key][tag].numpy())
    want = jt.forward_eval(jt.params, jt.buffers,
                           jnp.asarray(batches[0].data),
                           (jt.net.final_node,))[jt.net.final_node]
    [got] = tt.forward_eval(torch.from_numpy(batches[0].data),
                            [tt.net.final_node])
    np.testing.assert_allclose(got.reshape(4, -1),
                               np.asarray(want).reshape(4, -1), atol=1e-5)
    with pytest.raises(ValueError, match="batch_split needs stateless"):
        _with(keys + [("batch_split", "2")]).load_model(out)
    tr = _with(keys + [("remat", "2")])
    tr.load_model(out)
    with pytest.raises(AssertionError, match="keeps running buffers"):
        tr.update(batches[0])


def _with(keys):
    tt = NetTrainer()
    for k, v in [("batch_size", "4"), ("dev", "cpu")] + list(keys):
        tt.set_param(k, v)
    return tt


def test_zoo_text_matches_jax():
    """Every zoo builder's text equals the JAX package's, character for
    character, at its defaults and at other arguments."""
    from cxxnet_tpu.models import zoo as jzoo
    from cxxnet_tpu_torch.models import zoo
    calls = [("mlp", {}), ("mlp", dict(num_class=3, input_dim=20,
                                       hidden=(7, 5))),
             ("lenet", {}), ("alexnet", dict(num_class=10)),
             ("googlenet", {}), ("googlenet", dict(num_class=10,
                                                   aux_heads=False,
                                                   init="gaussian")),
             ("resnet", {}), ("resnet", dict(depth=56)),
             ("resnet", dict(num_class=100, depth=8, widths=(4, 8, 8),
                             input_side=8)),
             ("vgg", {}), ("vgg", dict(num_class=10, depth=11)),
             ("vgg", dict(depth=19)),
             ("transformer", dict(vocab=64, seq=16, dim=8, nlayer=2,
                                  nhead=2, packed=True))]
    for name, kw in calls:
        assert getattr(zoo, name)(**kw) == getattr(jzoo, name)(**kw), name


def test_resnet8_synth_steps_match_jax_cli(jopts, numpy_init, tmp_path):
    """The zoo ResNet-8 (batch_norm at every conv, a ``layer[stem->stem]
    = batch_norm`` self-loop) through both CLIs for 2
    ``synth_device_data`` steps from one JAX-written 0000.model: the
    0001.model params within 1e-5 and the moving statistics within 1e-5
    (they moved from their initial values)."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils import serializer
    from test_torch_cnn import _cli_conf
    from __graft_entry__ import _make_trainer
    net = _resnet8()
    jt = _make_trainer(net, 4, "cpu", extra=_SGD + [("silent", "1")])
    init = str(tmp_path / "0000.model")
    jt.save_model(init)
    extra = [("batch_size", "4"), ("num_round", "1"),
             ("synth_device_data", "1"), ("multi_step", "2")] + _SGD
    for name, task in (("jax", JTask), ("port", TTask)):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(_cli_conf("", tmp_path, name, init, extra))
        t = task()
        assert t.run([str(conf)]) == 0
    assert len(t.last_train["losses"]) == 2
    _, wp, wb, _ = serializer.load_model(str(tmp_path / "jax/0001.model"))
    _, gp, gb, _ = serializer.load_model(str(tmp_path / "port/0001.model"))
    assert wb and set(gb) == set(wb)
    for want, got in ((wp, gp), (wb, gb)):
        for key, group in want.items():
            for tag, v in group.items():
                np.testing.assert_allclose(got[key][tag], v, atol=1e-5,
                                           err_msg=f"{key}/{tag}")
    assert not np.allclose(gb["01-stem_bn"]["moving_mean"], 0)


def test_googlenet_conf_steps_with_its_shipped_keys(tmp_path):
    """example/ImageNet/GoogLeNet.conf with every key as shipped (its
    five lowering keys among them), on the CPU at batch 2 in float32:
    one ``synth_device_data`` step, a finite loss, the 9 inception
    modules' reduce convs fused in 9 groups of 3, the 9 concats and the
    pools that read them kept virtual, conv1 fed in space-to-depth
    form."""
    from cxxnet_tpu_torch.layers.base import ChSegs
    from cxxnet_tpu_torch.main import LearnTask
    conf = os.path.join(REPO, "example", "ImageNet", "GoogLeNet.conf")
    text = open(conf).read()
    assert all(re.search(rf"(?m)^{k} = {v}$", text)
               for k, v in GOOGLENET_KEYS)
    task = LearnTask()
    seen = []
    real = NetTrainer._loss_grads_outs

    def spy(self, inputs, labels, epoch=None):
        seen.append(tuple(inputs[0].shape))
        return real(self, inputs, labels, epoch)

    NetTrainer._loss_grads_outs = spy
    try:
        assert task.run([conf, "dev=cpu", "dtype=float32", "batch_size=2",
                         "synth_device_data=1", "multi_step=1",
                         "num_round=1", "save_model=0", "silent=1",
                         f"model_dir={tmp_path}"]) == 0
    finally:
        NetTrainer._loss_grads_outs = real
    net = task.net
    assert np.isfinite(task.last_train["losses"]).all()
    assert sorted(len(m) for m in net.net.fuse_groups.values()) == [3] * 9
    assert seen == [(2, 12, 115, 115)]
    nodes = net.net.forward(net.params, {0: net.stage_input(
        torch.zeros(2, 3, 224, 224))}, net.context())
    virtual = {net.net.cfg.node_names[i] for i, v in enumerate(nodes)
               if isinstance(v, ChSegs)}
    # the 9 concats, the pools of 8 of them (i3a's reads pool2), pool3,
    # pool4 and the average pool
    assert {n for n in virtual if n.endswith("_out")} == {
        f"i{m}_out" for m in ("3a", "3b", "4a", "4b", "4c", "4d", "4e",
                              "5a", "5b")}
    assert len(virtual) == 20


def test_remaining_refusals_name_their_item():
    """Nothing of the layers or the mesh stays refused: the moe layer
    (alone or as a pairtest side), the seq / expert / pipe mesh axes, the
    data-parallel plane's trainer keys and dp_* engine options, refused
    until they were ported, are taken."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.registry import NOT_PORTED, create_layer
    assert NOT_PORTED == ()
    for name in ("moe", "pairtest-moe-conv", "pairtest-conv-moe"):
        create_layer(name)
    for mesh in ("data:2,seq:2", "expert:2", "pipe:2,model:2",
                 "data:2,pipe:2"):
        NetTrainer().set_param("mesh", mesh)
    t = NetTrainer()
    for key in ("shard_opt_state", "fullc_gather", "update_on_server"):
        t.set_param(key, "1")
    t.set_param("mesh", "data:2,model:2")
    assert t.shard_opt_state == t.fullc_gather == 1
    for key, val in (("dp_overlap", "1"), ("dp_reduce_at", "step")):
        opts = EngineOptions()
        opts.set(key, val)
        assert getattr(opts, key) == val

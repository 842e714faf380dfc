"""The port's pairtest layer and ``testing.diff_layers`` against the JAX
package, on the CPU.

* the five pairtest cases of tests/test_layers.py (identical sides
  agree, divergence is detected, the gradient comparison, a broken
  backward is caught, the straight-through output is the master's),
  each against the JAX layer's diagnostics on the same inputs and
  weights;
* the shared probe-cotangent core on ones cotangents, where both
  packages compute the same numbers;
* ``diff_layers`` for conv / fullc / relu / max_pooling / lrn against
  the JAX ``diff_layers`` on the JAX package's draws, carried across by
  ``params_from_jax``;
* pairtest parameters in a snapshot both ways, the updater stepping
  both sides, and a CLI run of a small ``pairtest-conv-torch`` conf
  through both CLIs from one JAX-written snapshot: the same ``diag:``
  keys every ``print_step``, and the trained weights of both sides.

Tolerances: a relative error the two packages compute on the same
values (a forward difference, or gradients under ones cotangents)
agrees within 1e-5; an error that measures two implementations of one
function is noise in both (<= PAIRTEST_RTOL, the reference's 1e-5); the
probe cotangents are drawn from each package's own generator, so a
gradient error under random probes is compared by class (both under,
or both over, the threshold).  Weights after three steps: 1e-4.  A
conv pair inside a trained net: NET_DIAG_TOL.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.layers.base import ForwardContext as JCtx  # noqa: E402
from cxxnet_tpu.layers.pairtest import (  # noqa: E402
    probe_vjp_compare as jprobe)
from cxxnet_tpu.layers.registry import create_layer as jcreate  # noqa: E402
from cxxnet_tpu_torch.engine import EngineOptions  # noqa: E402
from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx  # noqa: E402
from cxxnet_tpu_torch.layers.pairtest import (  # noqa: E402
    PAIRTEST_RTOL, joined, probe_vjp_compare, side)
from cxxnet_tpu_torch.layers.registry import create_layer  # noqa: E402

SAME_TOL = 1e-5
WEIGHT_TOL = 1e-4
#: a conv pair's diagnostics inside a trained net: the reference's
#: elementwise relative error reads last-ulp noise on outputs that
#: cancel to ~0 as large errors (5.1e-4 measured at the CLI test's
#: shapes, where a broken side gives ~1); tests/test_plugin.py holds the
#: JAX package's to 5e-4 at its shapes
NET_DIAG_TOL = 1e-2


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(type_name, cfg):
    jl, tl = jcreate(type_name), create_layer(type_name)
    for k, v in cfg:
        jl.set_param(k, v)
        tl.set_param(k, v)
    return jl, tl


def _tctx(train, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return TCtx(train=train, opts=EngineOptions(), rng=gen)


def _diag(d, suffix):
    (v,) = [float(np.asarray(d[k])) for k in d if k.endswith(suffix)]
    return v


def _run_both(type_name, cfg, x, train, params=None):
    """(JAX diagnostics, port diagnostics, JAX out, port out) of one
    pairtest layer on x with the master's params (numpy, by tag)."""
    jl, tl = _pair(type_name, cfg)
    shapes = [tuple(x.shape)]
    assert jl.infer_shapes(shapes) == tl.infer_shapes(shapes)
    params = params or {}
    jp = {"master": {t: jnp.asarray(v) for t, v in params.items()},
          "slave": {t: jnp.asarray(v) for t, v in params.items()}} \
        if params else {}
    jctx = JCtx(train=train, rng=jax.random.PRNGKey(3)) if train \
        else JCtx(train=False)
    (jo,), _ = jl.forward(jp, {"master": {}, "slave": {}},
                          [jnp.asarray(x)], jctx)
    tp = joined({t: _t(v) for t, v in params.items()},
                {t: _t(v) for t, v in params.items()})
    tctx = _tctx(train)
    (to,) = tl.forward(tp, [_t(x)], tctx)
    return jctx.diagnostics, tctx.diagnostics, np.asarray(jo), \
        to.detach().numpy()


_POOL = [("kernel_size", "2"), ("stride", "2")]


def test_pairtest_identical_layers_agree():
    jd, td, _, _ = _run_both("pairtest-max_pooling-max_pooling", _POOL,
                             _rand(2, 3, 6, 6), train=False)
    assert sorted(td) == sorted(jd)
    assert _diag(td, "fwd_rel_err") < PAIRTEST_RTOL
    assert _diag(td, "fwd_rel_err") == _diag(jd, "fwd_rel_err") == 0.0


def test_pairtest_detects_divergence():
    jd, td, _, _ = _run_both("pairtest-max_pooling-avg_pooling", _POOL,
                             _rand(2, 3, 6, 6), train=False)
    assert _diag(td, "fwd_rel_err") > 1e-3
    assert abs(_diag(td, "fwd_rel_err") - _diag(jd, "fwd_rel_err")) \
        <= SAME_TOL * _diag(jd, "fwd_rel_err")


def test_pairtest_gradient_comparison():
    """Train mode records the input-grad and weight-grad relative errors
    (pairtest_layer-inl.hpp:95-118) beside the forward and weight
    ones: all ~0 for identical sides, in both packages."""
    rnd = np.random.RandomState(1)
    params = {"wmat": (rnd.randn(4, 3, 3, 3) * 0.1).astype(np.float32),
              "bias": rnd.randn(4).astype(np.float32)}
    jd, td, _, _ = _run_both(
        "pairtest-conv-conv", [("nchannel", "4"), ("kernel_size", "3")],
        _rand(2, 3, 8, 8), train=True, params=params)
    assert sorted(td) == sorted(jd)
    for suffix in ("fwd_rel_err", "in_grad_rel_err", "wgrad_rel_err",
                   "weight_rel_err"):
        assert _diag(td, suffix) < PAIRTEST_RTOL, suffix
        assert _diag(jd, suffix) < PAIRTEST_RTOL, suffix


def test_pairtest_catches_broken_backward():
    """relu against sigmoid: the forward and the input gradient differ
    (where x < 0 relu's value and gradient are 0, sigmoid's are not, so
    both errors are 1 in both packages whatever the probe)."""
    jd, td, _, _ = _run_both("pairtest-relu-sigmoid", [], _rand(2, 3, 8, 8),
                             train=True)
    for suffix in ("fwd_rel_err", "in_grad_rel_err"):
        assert _diag(td, suffix) > 1e-3
        assert abs(_diag(td, suffix) - _diag(jd, suffix)) <= SAME_TOL


def test_pairtest_straight_through_is_master():
    """The output is the master's value exactly, as the JAX layer's."""
    x = _rand(2, 3, 6, 6)
    _, _, jo, to = _run_both("pairtest-max_pooling-avg_pooling", _POOL, x,
                             train=True)
    from cxxnet_tpu_torch.ops import nn as TN
    np.testing.assert_array_equal(
        to, TN.max_pool2d(_t(x), 2, 2, 2, opts=EngineOptions()).numpy())
    np.testing.assert_array_equal(to, jo)


def test_pairtest_slave_gets_the_master_cotangent():
    """Both sides' weights get real gradients through the
    straight-through term, and a non-finite slave value is reported,
    not passed on."""
    tl = create_layer("pairtest-conv-torch")
    for k, v in (("slave:op", "conv"), ("nchannel", "4"),
                 ("kernel_size", "3")):
        tl.set_param(k, v)
    shapes = [(2, 3, 7, 7)]
    tl.infer_shapes(shapes)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = {t: v.requires_grad_() for t, v in
         tl.init_params(gen, shapes).items()}
    assert sorted(p) == ["master/bias", "master/wmat", "slave/bias",
                         "slave/wmat"]
    ctx = _tctx(True)
    (out,) = tl.forward(p, [_t(_rand(2, 3, 7, 7))], ctx)
    g = torch.autograd.grad(out.sum(), [p[t] for t in sorted(p)])
    for (a, b) in ((0, 2), (1, 3)):
        assert float((g[a] - g[b]).abs().max()) \
            <= SAME_TOL * float(g[a].abs().max())
    bad = {t: v.detach().clone() for t, v in p.items()}
    bad["slave/bias"][0] = float("nan")
    ctx = _tctx(True)
    (out,) = tl.forward(bad, [_t(_rand(2, 3, 7, 7))], ctx)
    assert torch.isfinite(out).all()
    assert not _diag(ctx.diagnostics, "fwd_rel_err") <= PAIRTEST_RTOL


def test_probe_core_matches_jax_on_ones_cotangents():
    """probe_vjp_compare with ones cotangents (no probe generator in the
    port, no probe key in the JAX package) on a conv pair whose sides
    hold different weights: the same input-grad error in both packages,
    and no weight-grad error in either (a conv's weight gradient does
    not depend on its weights)."""
    rnd = np.random.RandomState(2)
    x = _rand(2, 3, 8, 8, seed=4)
    mp = {"wmat": (rnd.randn(4, 3, 3, 3) * 0.1).astype(np.float32),
          "bias": rnd.randn(4).astype(np.float32)}
    sp = {t: (v + 0.01 * rnd.randn(*v.shape)).astype(np.float32)
          for t, v in mp.items()}
    cfg = [("nchannel", "4"), ("kernel_size", "3")]
    jm, tm = _pair("conv", cfg)
    js, ts = _pair("conv", cfg)
    for lay in (jm, tm, js, ts):
        lay.infer_shapes([x.shape])
    j = jprobe(jm, js, {t: jnp.asarray(v) for t, v in mp.items()},
               {t: jnp.asarray(v) for t, v in sp.items()}, {}, {},
               [jnp.asarray(x)], lambda: JCtx(train=True), None)
    t = probe_vjp_compare(tm, ts, {k: _t(v) for k, v in mp.items()},
                          {k: _t(v) for k, v in sp.items()}, {}, {},
                          [_t(x)], lambda: _tctx(True), None)
    assert float(t[4]) > 1e-3
    assert abs(float(t[4]) - float(j[4])) <= SAME_TOL * float(j[4])
    assert float(t[5]) <= PAIRTEST_RTOL and float(j[5]) <= PAIRTEST_RTOL


# ------------------------------------------------------------ diff_layers
_LRN = [("local_size", "5"), ("beta", "0.75"), ("knorm", "1")]
#: (master type, master cfg, slave type, slave cfg, input shape, same)
DIFF_CASES = {
    "conv": ("conv", [("nchannel", "4"), ("kernel_size", "3"),
                      ("pad", "1")],
             "torch", [("op", "conv"), ("nchannel", "4"),
                       ("kernel_size", "3"), ("pad", "1")],
             (2, 3, 8, 8), True),
    "fullc": ("fullc", [("nhidden", "5")],
              "torch", [("op", "fullc"), ("nhidden", "5")],
              (3, 1, 1, 12), True),
    "relu": ("relu", [], "tanh", [], (2, 3, 8, 8), False),
    "max_pooling": ("max_pooling", _POOL, "avg_pooling", _POOL,
                    (2, 3, 6, 6), False),
    "lrn": ("lrn", _LRN + [("alpha", "0.01")],
            "lrn", _LRN + [("alpha", "0.02")], (2, 8, 5, 5), False),
}


def _make(create, type_name, cfg):
    lay = create(type_name)
    for k, v in cfg:
        lay.set_param(k, v)
    return lay


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_layers_matches_jax(case):
    """The JAX ``diff_layers`` and the port's on the JAX package's draws
    (inputs and master weights from the same key split).  A pair of one
    function (native against the torch plugin) is under the reference's
    threshold in the port, where both sides are torch on the CPU; the
    JAX package holds XLA against torch there, whose elementwise
    gradient errors reach ~2e-4, so its side is held to 1e-3.  A
    divergent pair has the same forward error in both and an
    input-gradient error over the threshold in both."""
    from cxxnet_tpu.testing import diff_layers as jdiff
    from cxxnet_tpu_torch.nnet.trainer import params_from_jax
    from cxxnet_tpu_torch.testing import diff_layers
    mt, mc, st, sc, shape, same = DIFF_CASES[case]
    key = jax.random.PRNGKey(0)
    kin, kparam, _, _ = jax.random.split(key, 4)
    jm = _make(jcreate, mt, mc)
    jm.infer_shapes([shape])
    x = np.asarray(jax.random.normal(jax.random.fold_in(kin, 0), shape))
    jp = jax.tree.map(np.asarray, jm.init_params(kparam, [shape]))
    want = jdiff(jm, _make(jcreate, st, sc), [shape], key=key)
    tp, _ = params_from_jax({"l": jp}, {})
    got = diff_layers(_make(create_layer, mt, mc),
                      _make(create_layer, st, sc), [shape],
                      inputs=[_t(x)], params=tp.get("l", {}))
    assert sorted(got) == sorted(want)
    if same:
        for k in got:
            assert got[k] <= PAIRTEST_RTOL and want[k] <= 1e-3, k
        return
    assert got["fwd_rel_err"] > 1e-3
    assert abs(got["fwd_rel_err"] - want["fwd_rel_err"]) \
        <= SAME_TOL * want["fwd_rel_err"]
    assert got["in_grad_rel_err"] > 1e-3 and want["in_grad_rel_err"] > 1e-3
    assert got["loss_rel_err"] == want["loss_rel_err"] == 0.0


def test_diff_layers_draws_from_its_generator():
    """Without given inputs: a seeded generator repeats, and a clean
    pair stays under the threshold."""
    from cxxnet_tpu_torch.testing import diff_layers
    cfg = [("nchannel", "4"), ("kernel_size", "3"), ("pad", "1")]
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        runs.append(diff_layers(_make(create_layer, "conv", cfg),
                                _make(create_layer, "conv", cfg),
                                [(2, 3, 8, 8)], gen=gen))
    assert runs[0] == runs[1]
    assert max(runs[0].values()) <= PAIRTEST_RTOL


# -------------------------------------------------------- trainer and CLI
PAIR_NET = """
netconfig=start
layer[+1:pt] = pairtest-conv-torch:pt
  slave:op = conv
  nchannel = 4
  kernel_size = 5
  stride = 2
  init_sigma = 0.1
layer[+1] = relu
layer[+1] = flatten
layer[+1:fc] = fullc:fc
  nhidden = 10
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,28,28
"""


def test_pairtest_snapshot_crosses_both_ways(tmp_path):
    """A JAX-written snapshot of a pairtest net loads in the port (its
    nested master / slave groups as ``master/<tag>`` tags, the
    updater state too) and the port's snapshot loads in the JAX
    package with the same arrays."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu.utils import serializer as jser
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    jt = _make_trainer(PAIR_NET, 8, "cpu",
                       extra=[("silent", "1"), ("momentum", "0.9")])
    path = str(tmp_path / "j.model")
    jt.save_model(path, with_opt_state=True)
    tt = NetTrainer()
    for k, v in [("dev", "cpu"), ("batch_size", "8"), ("silent", "1")]:
        tt.set_param(k, v)
    tt.load_model(path)
    pkey = "00-pt"
    assert sorted(tt.params[pkey]) == ["master/bias", "master/wmat",
                                       "slave/bias", "slave/wmat"]
    assert tt.hypers[pkey]["slave/wmat"].tag == "wmat"
    out = str(tmp_path / "t.model")
    tt.save_model(out, with_opt_state=True)
    _, want, _, wopt = jser.load_model(path)
    _, got, _, gopt = jser.load_model(out)
    for side in ("master", "slave"):
        for tag in ("wmat", "bias"):
            np.testing.assert_array_equal(got[pkey][side][tag],
                                          want[pkey][side][tag])
            assert set(gopt[pkey][side][tag]) == set(wopt[pkey][side][tag])


def _mnist(tmp_path):
    subprocess.run([sys.executable, os.path.join(REPO,
                                                 "tools/make_synth_mnist.py"),
                    "--out", str(tmp_path / "data"), "--train", "64",
                    "--test", "32"], check=True, capture_output=True)


def test_pairtest_trainer_steps_match_jax():
    """The JAX trainer and the port's on one pairtest-conv-torch net
    (the port's weights carried from the JAX trainer's nested groups),
    three sgd-momentum steps on the same batches: both sides' weights
    and the fullc's agree within 1e-4 after them (the updater steps the
    slave from its own gradient in both), and the port's trainer keeps
    each step's diagnostics, within NET_DIAG_TOL, with the JAX keys."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    from cxxnet_tpu_torch.utils.config import parse_config_string
    keys = [("eta", "0.1"), ("momentum", "0.9"), ("eval_train", "0"),
            ("silent", "1")]
    jt = _make_trainer(PAIR_NET, 8, "cpu", extra=keys)
    tt = NetTrainer()
    for k, v in parse_config_string(PAIR_NET):
        tt.set_param(k, v)
    for k, v in [("batch_size", "8"), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.init_model()
    assert tt.has_diagnostics
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params), {}))
    rnd = np.random.RandomState(0)
    for _ in range(3):
        data = rnd.rand(8, 1, 28, 28).astype(np.float32)
        label = rnd.randint(0, 10, (8, 1)).astype(np.float32)
        idx = np.arange(8, dtype=np.uint32)
        jt.update(JBatch(data=data, label=label, index=idx))
        tt.update(DataBatch(data=data, label=label, index=idx))
        got = tt.diagnostics_host()
        assert sorted(got) == sorted(jt._last_diags)
        assert max(got.values()) <= NET_DIAG_TOL, got
    for side in ("master", "slave"):
        for tag in ("wmat", "bias"):
            np.testing.assert_allclose(
                tt.params["00-pt"][f"{side}/{tag}"].numpy(),
                np.asarray(jt.params["00-pt"][side][tag]),
                atol=WEIGHT_TOL, err_msg=f"{side}/{tag}")
    np.testing.assert_allclose(tt.params["03-fc"]["wmat"].numpy(),
                               np.asarray(jt.params["03-fc"]["wmat"]),
                               atol=WEIGHT_TOL)


def test_cli_pairtest_conv_torch_matches_jax_cli(tmp_path, capsys,
                                                 monkeypatch):
    """``pairtest-conv-torch`` trained one round (4 steps of 16) through
    both CLIs: every ``print_step`` a ``diag:`` line with the same keys
    in both, in the JAX package's words, every port value within
    NET_DIAG_TOL, and an exceedance warning in the JAX package's words
    for each value over the reference's 1e-5.  The port reads the
    steps' diagnostics to the host once a ``print_step``, not once a
    step."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch import main as tmain
    from cxxnet_tpu_torch.main import LearnTask as TTask
    reads = []
    to_host = tmain.diagnostics_to_host

    def counted(steps):
        reads.append(len(steps))
        return to_host(steps)

    monkeypatch.setattr(tmain, "diagnostics_to_host", counted)
    _mnist(tmp_path)
    body = (PAIR_NET + "dev = cpu\ntask = train\nbatch_size = 16\n"
            "num_round = 1\nprint_step = 2\nmetric = error\n"
            "save_model = 0\neta = 0.1\nmomentum = 0.9\n"
            "data = train\niter = mnist\n"
            f"  path_img = {tmp_path}/data/train-images-idx3-ubyte.gz\n"
            f"  path_label = {tmp_path}/data/train-labels-idx1-ubyte.gz\n"
            "  input_flat = 0\niter = end\n")
    lines = {}
    # one intra-op thread: the elementwise errors are set by the outputs
    # nearest 0, whose rounding follows the conv's reduction order (at 2
    # threads, 0.0408 at step 2 of this run)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, task in (("jax", JTask), ("port", TTask)):
            conf = tmp_path / f"{name}.conf"
            conf.write_text(body + f"model_dir = {tmp_path}/{name}\n")
            capsys.readouterr()
            t = task()
            assert t.run([str(conf)]) == 0
            cap = capsys.readouterr()
            lines[name] = re.findall(r"diag: (.*)", cap.out + cap.err)
    finally:
        torch.set_num_threads(threads)
    warned = re.findall(r"(pt:\w+): err=(\S+) exceeds 1e-05",
                        cap.out + cap.err)
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for jl, pl in zip(lines["jax"], lines["port"]):
        jkv = dict(kv.split("=") for kv in jl.split())
        pkv = dict(kv.split("=") for kv in pl.split())
        assert list(pkv) == list(jkv) == [
            "pt:fwd_rel_err", "pt:in_grad_rel_err", "pt:weight_rel_err",
            "pt:wgrad_rel_err"]
        assert all(float(v) <= NET_DIAG_TOL for v in pkv.values())
    over = [(k, d[k]) for d in t.last_train["diags"][1::2] for k in sorted(d)
            if d[k] > PAIRTEST_RTOL]
    assert [k for k, _ in warned] == [k for k, _ in over]
    # the task keeps every step's diagnostics, read at each print_step
    assert len(t.last_train["diags"]) == 4
    assert reads == [2, 2]


def test_fusion_passes_leave_a_pairtest_alone():
    """No peephole of the trainer rewrites a pairtest layer: under
    ``conv_sibling_fuse`` two pairtest convs reading one value stay two
    connections, where two plain convs fuse; under the relu -> pool
    reorder (``pool_relu_fuse = 1``) a pairtest conv keeps its bias,
    where a plain conv's moves to the pool."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    conv = "  nchannel = 4\n  kernel_size = 3\n"

    def trainer(body):
        tr = NetTrainer()
        for k, v in parse_config_string(
                "netconfig=start\n" + body +
                "layer[+1] = flatten\n"
                "layer[+1] = fullc\n  nhidden = 3\n"
                "layer[+0] = softmax\n"
                "netconfig=end\ninput_shape = 2,8,8\nbatch_size = 2\n"
                "dev = cpu\nsilent = 1\nslave:op = conv\n"
                "pool_relu_fuse = 1\nconv_sibling_fuse = 1\n"):
            tr.set_param(k, v)
        tr.init_model()
        return tr

    def siblings(a, b):
        return trainer("layer[0->1,2] = split\n"
                       f"layer[1->3] = {a}\n{conv}"
                       f"layer[2->4] = {b}\n{conv}"
                       "layer[3,4->5] = ch_concat\n")

    def relu_pool(a):
        return trainer(f"layer[0->1] = {a}\n{conv}layer[1->2] = relu\n"
                       "layer[2->3] = max_pooling\n  kernel_size = 2\n"
                       "  stride = 2\n")

    assert siblings("conv", "conv").net.fuse_groups
    pair = siblings("pairtest-conv-torch", "pairtest-conv-conv")
    assert not pair.net.fuse_groups
    assert relu_pool("conv").net.connections[0].layer.defer_bias
    tr = relu_pool("pairtest-conv-torch")
    assert not tr.net.connections[0].layer.master.defer_bias
    assert tr.net.connections[2].layer.deferred_bias_key is None
    rnd = np.random.RandomState(0)
    for t in (pair, tr):
        t.update(DataBatch(data=rnd.rand(2, 2, 8, 8).astype(np.float32),
                           label=np.array([[0.0], [2.0]], np.float32),
                           index=np.arange(2, dtype=np.uint32)))
    assert len(pair.diagnostics_host()) == 8
    assert len(tr.diagnostics_host()) == 4


@pytest.mark.parametrize("type_name,cfg", [
    ("pairtest-dropout-dropout", [("threshold", "0.5")]),
    ("pairtest-batch_norm-batch_norm", []),
    ("pairtest-insanity-insanity", []),
])
def test_pairtest_sides_draw_alike_and_keep_their_buffers(type_name, cfg):
    """Random masks and running buffers inside a pairtest: both sides
    draw the same masks (the slave from a clone of the state the master
    started at), each side keeps its own buffers, and identical sides
    agree exactly, as in the JAX package (whose layer gives 0 here
    too); the step's generator moves on as the master's draws move it."""
    jl, tl = _pair(type_name, cfg)
    x = _rand(4, 3, 5, 5)
    shapes = [x.shape]
    tl.infer_shapes(shapes)
    jl.infer_shapes(shapes)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tl.init_params(gen, shapes)
    b = tl.init_buffers(shapes, torch.device("cpu"))
    assert sorted(b) == sorted(f"{s}/{t}" for s in ("master", "slave")
                               for t in side(b, "master"))
    ctx = _tctx(True)
    alone = torch.Generator()
    alone.manual_seed(0)
    m = create_layer(type_name.split("-")[1])
    for k, v in cfg:
        m.set_param(k, v)
    m.infer_shapes(shapes)
    (want,), _ = m.forward_buffers(side(p, "master"), side(b, "master"),
                                   [_t(x)], TCtx(train=True,
                                                 opts=EngineOptions(),
                                                 rng=alone))
    (out,), nb = tl.forward_buffers(p, b, [_t(x)], ctx)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(ctx.rng.get_state(), alone.get_state())
    for k, v in side(nb, "master").items():
        assert torch.equal(v, side(nb, "slave")[k]), k
    for suffix in ("fwd_rel_err", "in_grad_rel_err", "wgrad_rel_err"):
        assert _diag(ctx.diagnostics, suffix) == 0.0, suffix
    jp = jl.init_params(jax.random.PRNGKey(0), shapes)
    jb = jl.init_buffers(shapes)
    jctx = JCtx(train=True, rng=jax.random.PRNGKey(3))
    jl.forward(jp, jb, [jnp.asarray(x)], jctx)
    assert _diag(jctx.diagnostics, "fwd_rel_err") == 0.0

"""The port's traced-graph lint (cxxnet_tpu_torch/analysis/graph_lint.py)
against the JAX package's jaxpr lint, on the CPU.

* the cases of tests/test_analysis.py's jaxpr lint: a big closure
  constant is an error, the state-leaf rule warns (in the port: a
  buffer that comes back in another dtype, torch's form of the JAX
  package's weak-typed leaf), a plain net is clean, float64 values are
  flagged (the JAX side's f64 case fails there; nothing here is pinned
  to it), and the dp-coverage rule kept for the multi-GPU plane;
* the trace itself: forward, backward and update in one graph on meta,
  no kernel launched (the wrappers take their plain versions), no CUDA
  call, the trainer's state put back;
* ``task = check`` on every example conf: its ``jaxpr``-scope findings
  equal the JAX package's, but for two by-design differences (the
  closing info line counts graph nodes, not jaxpr equations; a conf the
  port refused before any trace, none today); its SPMD findings equal
  the JAX package's by key, severity and count, from the same two check
  runs, but for one by-design difference (``BY_DESIGN_SPMD``).
"""

import collections
import functools
import glob
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu_torch.analysis import graph_lint, run_check  # noqa: E402
from cxxnet_tpu_torch.layers import registry as layer_registry  # noqa: E402
from cxxnet_tpu_torch.layers.base import Layer  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import NetTrainer  # noqa: E402
from cxxnet_tpu_torch.utils.config import (  # noqa: E402
    parse_config_file, parse_config_string)

EXAMPLES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "example", "**", "*.conf"), recursive=True))


class _BigConstLayer(Layer):
    """Deliberate closure-capture bug: a >1 MiB array baked into
    forward."""

    type_names = ("bigconst_test",)

    def __init__(self):
        super().__init__()
        self._big = torch.ones((512, 600))  # 1.2 MiB

    def infer_shapes(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [inputs[0] + self._big.sum() * 0]


class _RetypedBufferLayer(Layer):
    """A running buffer the step hands back in another dtype."""

    type_names = ("retyped_test",)

    def infer_shapes(self, in_shapes):
        return [in_shapes[0]]

    def init_buffers(self, in_shapes, device):
        return {"count": torch.zeros((), device=device)}

    def forward_buffers(self, params, buffers, inputs, ctx):
        return [inputs[0]], {"count": (buffers["count"] + 1).bfloat16()}


class _F64Layer(Layer):
    """A stray float64 round trip inside forward."""

    type_names = ("f64_test",)

    def infer_shapes(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        return [inputs[0].double().float()]


@pytest.fixture
def _test_layers():
    for cls in (_BigConstLayer, _RetypedBufferLayer, _F64Layer):
        layer_registry.register(cls)
    yield
    for cls in (_BigConstLayer, _RetypedBufferLayer, _F64Layer):
        for name in cls.type_names:
            layer_registry._REGISTRY.pop(name, None)
    from cxxnet_tpu_torch.analysis import registry as areg
    areg.layer_scope.cache_clear()


def _tiny_trainer(body_layer, extra=""):
    net = NetTrainer()
    for k, v in parse_config_string(
            "netconfig=start\n"
            f"layer[+1] = {body_layer}\n"
            "layer[+1] = fullc\n  nhidden = 4\n"
            "layer[+0] = softmax\n"
            "netconfig=end\n"
            "input_shape = 1,1,8\nbatch_size = 4\ndev = cpu\nsilent = 1\n"
            + extra):
        net.set_param(k, v)
    net.init_model(torch.device("meta"))
    return net


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def test_graph_lint_flags_big_closure_constant(_test_layers):
    findings = graph_lint.lint_trainer(_tiny_trainer("bigconst_test"))
    hits = [f for f in _errors(findings) if "closure-captured" in f.message]
    assert hits, "\n".join(f.format() for f in findings)
    assert "(512, 600) float32 (1.2 MiB)" in hits[0].message
    assert hits[0].scope == "jaxpr"


def test_graph_lint_flags_retyped_state_leaf(_test_layers):
    findings = graph_lint.lint_trainer(_tiny_trainer("retyped_test"))
    hits = [f for f in findings if "comes back as" in f.message]
    assert hits, "\n".join(f.format() for f in findings)
    (hit,) = hits
    assert hit.severity == "warn" and hit.message.startswith(
        "buffers leaf ['00-retyped_test']['count'] goes into the traced "
        "step as float32 and comes back as bfloat16")


def test_graph_lint_clean_on_plain_net():
    findings = graph_lint.lint_trainer(_tiny_trainer("sigmoid"))
    assert not _errors(findings), "\n".join(f.format() for f in findings)
    assert [f.severity for f in findings] == ["info"]
    assert findings[0].message.startswith("traced train step: ")


def test_graph_lint_flags_f64_promotion(_test_layers):
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(lambda x: x * 2.0)(torch.zeros(3, dtype=torch.float64))
    found = graph_lint.graph_findings(gm)
    assert [f.message.split(" in the")[0] for f in found] == [
        "float64 values produced by 1 'mul' op(s)"]
    findings = graph_lint.lint_trainer(_tiny_trainer("f64_test"))
    assert any("float64 values produced by" in f.message
               and f.severity == "warn" for f in findings)


def test_dp_coverage_findings():
    hits = graph_lint.dp_coverage_findings(["a", "b", "c"], ["a", "c"])
    assert len(hits) == 1 and hits[0].severity == "error"
    assert "'b'" in hits[0].message
    assert not graph_lint.dp_coverage_findings(["a"], ["a"])


@pytest.mark.parametrize("extra", [
    "mesh = data:4\ndev = cpu:0-3\n",
    "mesh = data:4\ndev = cpu:0-3\nshard_opt_state = 1\n",
    "mesh = data:2,model:2\ndev = cpu:0-3\nfullc_gather = 1\n",
    "mesh = data:4\ndev = cpu:0-3\nremat = 2\n",
    "dev = cpu\n"], ids=["data", "zero", "model", "fallback", "one"])
def test_dp_findings_match_jax(extra):
    """The dp driver of the traced pass (the JAX package's
    ``_dp_findings``) under dp_overlap = 1 on a mesh config: the
    bucket plan covers every param group (no finding), and a fallback
    gate, or one device, gives the same info line."""
    from cxxnet_tpu import engine
    from cxxnet_tpu.analysis import jaxpr_lint
    from __graft_entry__ import _make_trainer
    text = ("netconfig=start\nlayer[+1] = fullc:fc1\n  nhidden = 64\n"
            "layer[+1] = relu\nlayer[+1] = fullc:fc2\n  nhidden = 4\n"
            "layer[+0] = softmax\nnetconfig=end\ninput_shape = 1,1,16\n"
            "batch_size = 8\nsilent = 1\ndp_bucket_mb = 0.001\n" + extra)
    pairs = parse_config_string(text)
    tt = NetTrainer()
    for k, v in pairs + [("dp_overlap", "1")]:
        tt.set_param(k, v)
    tt.init_model(torch.device("meta"))
    saved = (engine.opts.dp_overlap, engine.opts.dp_bucket_mb)
    try:
        engine.opts.set("dp_overlap", "1")
        dev = dict(pairs)["dev"]
        jt = _make_trainer(text, 8, dev, extra=[
            kv for kv in pairs if kv[0] in ("mesh", "shard_opt_state",
                                           "fullc_gather", "remat")])
        jf = jaxpr_lint._dp_findings(jt)
    finally:
        engine.opts.set("dp_overlap", saved[0])
        engine.opts.set("dp_bucket_mb", saved[1])
    pf = graph_lint.dp_findings(tt)
    assert [(f.severity, f.message) for f in pf] \
        == [(f.severity, f.message) for f in jf]


def test_trace_is_one_device_free_step(monkeypatch):
    """Forward, backward and the update are one graph (the adam update's
    sqrt among its nodes), traced with the AlexNet-class kernels' routes
    on: the LRN and conv-wgrad wrappers take their plain versions on
    meta and launch nothing; no call into torch.cuda but torch's own
    tracer asking is_available, and no CUDA context; the trainer's
    state objects are put back."""
    from cxxnet_tpu_torch.ops import conv_wgrad, lrn, pool
    touched, plain = [], []
    for name in ("_lazy_init", "current_device", "synchronize",
                 "device_count", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: touched.append(_n))
    # is_available only from torch's own tracer: make_fx's fake-tensor
    # mode asks it on entry (FakeTensorMode.avoid_device_init)
    tracer_dirs = tuple(os.path.join(os.path.dirname(torch.__file__), d)
                        + os.sep for d in ("_subclasses", "fx"))
    real_is_available = torch.cuda.is_available

    def is_available():
        caller = sys._getframe(1).f_code.co_filename
        if not caller.startswith(tracer_dirs):
            touched.append(f"is_available from {caller}")
        return real_is_available()

    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    for mod, name in ((lrn, "lrn_fwd_plain"), (lrn, "lrn_bwd_plain"),
                      (conv_wgrad, "conv_wgrad_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            plain.append((_n, a[0].device.type)), _f(*a, **k))[1])
    counters = (lrn.lrn_fwd, lrn.lrn_bwd, conv_wgrad.conv_wgrad_hwcn_pallas,
                pool.max_pool_fwd, pool.max_pool_bwd)
    before = [f.launches for f in counters]
    tr = NetTrainer()
    for k, v in parse_config_string(
            "netconfig=start\n"
            "layer[+1] = conv\n  nchannel = 8\n  kernel_size = 5\n"
            "  stride = 2\n"
            "layer[+1] = relu\n"
            "layer[+1] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
            "layer[+1] = lrn\n  local_size = 5\n  alpha = 0.001\n"
            "  beta = 0.75\n"
            "layer[+1] = flatten\n"
            "layer[+1] = fullc\n  nhidden = 4\n"
            "layer[+0] = softmax\n"
            "netconfig=end\n"
            "input_shape = 3,31,31\nbatch_size = 4\ndev = gpu\nsilent = 1\n"
            "updater = adam\npallas_lrn = 1\nfast_wgrad = hwcn\n"):
        tr.set_param(k, v)
    tr.init_model(torch.device("meta"))
    params = tr.params
    gm, b, a = graph_lint.trace_step(tr)
    targets = {str(n.target) for n in gm.graph.nodes}
    assert "aten.sqrt.default" in targets and "aten.mm.default" in targets
    assert tr.params is params
    assert [f.launches for f in counters] == before and not touched
    assert not torch.cuda.is_initialized()
    assert sorted(set(plain)) == [("conv_wgrad_plain", "meta"),
                                  ("lrn_bwd_plain", "meta"),
                                  ("lrn_fwd_plain", "meta")]
    assert b == a and set(b) == {"params", "opt_state", "buffers"}


def test_trace_refuses_a_trainer_with_storage():
    tr = NetTrainer()
    for k, v in parse_config_string(
            "netconfig=start\nlayer[+1] = fullc\n  nhidden = 4\n"
            "layer[+0] = softmax\nnetconfig=end\n"
            "input_shape = 1,1,8\nbatch_size = 4\ndev = cpu\nsilent = 1\n"):
        tr.set_param(k, v)
    tr.init_model()
    with pytest.raises(ValueError, match="built on meta"):
        graph_lint.trace_step(tr)


#: the port's jaxpr-scope findings that differ from the JAX package's by
#: design: the closing info line counts graph nodes and lifted
#: constants where the JAX package counts jaxpr equations and top-level
#: constants
BY_DESIGN_COUNTS = "traced train step: "
#: a multi-device conf: the port refuses it before any trace (its one
#: jaxpr-scope finding is this info line, after the config lint's
#: not-ported errors), where the JAX package traces it on host devices
#: or skips the trace for want of them
BY_DESIGN_REFUSED = ("traced-graph pass skipped: the config uses what "
                     "cxxnet_tpu_torch does not implement (errors above)")


#: the port's SPMD findings that differ from the JAX package's by design,
#: by conf: ImageNet.conf's conv1 bias gradient is summed in f32 and cast
#: to the bf16 parameter's dtype, and the updater casts it back; the
#: port's trace is one flat graph and sees the pair, the JAX walk keeps
#: a producer map per nesting level and does not see it across the
#: custom_vjp boundary of the same sum
BY_DESIGN_SPMD = {
    "example/ImageNet/ImageNet.conf": [("spmd_cast_roundtrip", "warn")],
}


def _jaxpr(findings):
    return [f for f in findings if f.scope == "jaxpr"]


@functools.lru_cache(maxsize=None)
def _both_checks(conf):
    """``task = check``'s findings on an example conf, the port's and the
    JAX package's (each conf checked once for both tests below)."""
    from cxxnet_tpu.analysis import run_check as jrun_check
    from cxxnet_tpu.utils.config import parse_config_file as jparse
    path = os.path.join(REPO, conf)
    return (run_check(parse_config_file(path), path)[0],
            jrun_check(jparse(path), path)[0])


@pytest.mark.parametrize("conf", EXAMPLES)
def test_example_conf_graph_lint_matches_jax(conf):
    """``task = check``'s jaxpr-scope findings on each example conf: the
    port's and the JAX package's in the same order with the same
    severity, key and words, but for the by-design differences above;
    no error in either."""
    pall, jall = _both_checks(conf)
    pf = _jaxpr(pall)
    jf = _jaxpr(jall)
    assert not [f for f in pf + jf if f.severity == "error"]
    if [f.message for f in pf] == [BY_DESIGN_REFUSED]:
        assert any("not ported to cxxnet_tpu_torch" in f.message
                   for f in pall if f.severity == "error")
        return
    assert len(pf) == len(jf), ([f.format() for f in pf],
                                [f.format() for f in jf])
    for p, j in zip(pf, jf):
        assert p.severity == j.severity == "info"
        if p.message.startswith(BY_DESIGN_COUNTS) \
                and j.message.startswith(BY_DESIGN_COUNTS):
            continue
        assert (p.key, p.message) == (j.key, j.message)


@pytest.mark.parametrize("conf", EXAMPLES)
def test_example_conf_spmd_matches_jax(conf):
    """``task = check``'s SPMD findings on each example conf: the same
    keys with the same severities and counts as the JAX package's (the
    census, the donation / in-place summary, the deep bf16 sums of the
    bf16 CNNs), but for ``BY_DESIGN_SPMD``; no error in either."""
    pall, jall = _both_checks(conf)

    def spmd(fs):
        return collections.Counter((f.key, f.severity) for f in fs
                                   if f.scope == "spmd")
    got, want = spmd(pall), spmd(jall)
    got.subtract(collections.Counter(BY_DESIGN_SPMD.get(conf, [])))
    assert +got == want, (sorted(got.items()), sorted(want.items()))
    assert not [k for k, sev in got if sev == "error"]

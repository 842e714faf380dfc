"""The port's SPMD deep lint (``cxxnet_tpu_torch/analysis/spmdlint.py``)
against the JAX package's (tests/test_spmdlint.py), on the CPU.

* The rules that take a list of collectives or a report (axis, wire,
  dist-round and donation findings) on the JAX tests' inputs: the same
  keys and severities as the JAX functions give, side by side.
* The collective record of a traced step: a virtual mesh's calls into
  ``parallel/mesh.py`` (all_reduce, all_gather, ring_shift, a pipeline
  handoff) land in call order with their axes, and nothing else does.
* Dtype flow over a ``make_fx`` graph: the cast round-trip and the bf16
  deep-sum severities of the JAX tests' functions, the same keys and
  severities as the JAX function gives on their jaxprs.
* Negative fixtures through the port's ``task = check`` CLI (a layer or
  an updater registered for the test): deep accumulation through a
  downcast, an f32 reduction on the data axis under a bf16 wire, an
  optimizer leaf replaced instead of updated in place; each exits 1
  with exactly its key, as in the JAX package.  ``spmd_check = 0`` skips
  the pass.  The JAX fixtures with no torch counterpart (a divergent
  ``lax.cond``, a psum over a size-1 axis, the XLA alias map) are not
  ported: the port traces no branch, issues nothing over a size-1
  axis and has no donation (the module docstring says why).
* The example confs' SPMD findings against the JAX package's are held
  in tests/test_torch_graph_lint.py, beside the graph lint's, from the
  same two check runs.
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from cxxnet_tpu.analysis import spmdlint as jlint  # noqa: E402
from cxxnet_tpu_torch.analysis import registry as areg  # noqa: E402
from cxxnet_tpu_torch.analysis import run_check, spmdlint  # noqa: E402
from cxxnet_tpu_torch.layers import registry as layer_registry  # noqa
from cxxnet_tpu_torch.layers.base import Layer  # noqa: E402
from cxxnet_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from cxxnet_tpu_torch.updater import updaters as updlib  # noqa: E402
from cxxnet_tpu_torch.utils.config import (parse_config_file,  # noqa: E402
                                           parse_config_string)

#: the port's op names for the JAX package's primitives
PRIM = {"psum": "all_reduce", "all_gather": "all_gather",
        "ppermute": "ring_shift"}


def _keys(findings):
    return sorted((f.key, f.severity) for f in findings)


def _pair(prim, axes, dtype, n, itemsize=4):
    """The same collective as a JAX op and a port op."""
    return (jlint.CollectiveOp(prim, axes, dtype, (n,), n * itemsize),
            spmdlint.CollectiveOp(PRIM[prim], axes, dtype, (n,),
                                  n * itemsize))


# ---------------------------------------------------------------- rules

@pytest.mark.parametrize("sizes", [{"data": 2, "model": 1}, {"data": 2},
                                   {"data": 2, "model": 2}])
def test_axis_findings_match_jax(sizes):
    """Dead (size 1) and unknown axes, as the JAX rule finds them."""
    jop, top = _pair("psum", ("model",), "float32", 4)
    assert _keys(spmdlint.axis_findings([top], sizes)) \
        == _keys(jlint.axis_findings([jop], sizes))


@pytest.mark.parametrize("wire_bf16,n", [(False, 1 << 16), (True, 4),
                                         (True, 1 << 16)])
def test_wire_findings_match_jax(wire_bf16, n):
    """An f32 reduction on the data axis of 256 KiB under a declared
    bf16 wire is an error; a small one (the reduced loss) and an
    undeclared wire are quiet."""
    jop, top = _pair("psum", ("data",), "float32", n)
    assert _keys(spmdlint.wire_findings([top], wire_bf16)) \
        == _keys(jlint.wire_findings([jop], wire_bf16))


@pytest.mark.parametrize("cfg,with_ops", [
    ([("dist_num_worker", "4"), ("eta", "0.1")], True),
    ([("dist_num_worker", "4")], False),
    ([("dist_num_worker", "1")], True),
    ([("dist_num_worker", "x")], True),
    ([("eta", "0.1")], True)])
def test_dist_round_findings_match_jax(cfg, with_ops):
    jop, top = _pair("psum", ("data",), "float32", 4)
    got = spmdlint.dist_round_findings(cfg, [top] if with_ops else [])
    want = jlint.dist_round_findings(cfg, [jop] if with_ops else [])
    assert _keys(got) == _keys(want)
    for g, w in zip(got, want):
        assert "LOCAL iterator" in g.message and "zero data" in g.suggestion
        assert g.suggestion == w.suggestion


def test_donation_findings_classes_match_jax():
    """The report rows of the JAX test: an undonated parameter leaf is
    an error naming it, with the summary info; no report is the skip
    notice."""
    rows = [
        {"tree": "params", "path": "['fc']['wmat']", "bytes": 1 << 20,
         "donated": False},
        {"tree": "opt_state", "path": "['fc']['m']", "bytes": 1 << 20,
         "donated": True},
    ]
    report = {"source": "in-place", "leaves": rows, "alias_bytes": 1 << 20}
    got = spmdlint.donation_findings(report)
    want = jlint.donation_findings(dict(report, source="lowered",
                                        n_args=4))
    assert _keys(got) == _keys(want)
    (und,) = [f for f in got if f.key == "spmd_undonated"]
    assert und.severity == "error" and "wmat" in und.message
    assert _keys(spmdlint.donation_findings(None)) \
        == _keys(jlint.donation_findings(None)) == [("spmd_donation",
                                                     "info")]


def test_sequence_summary_census():
    """The census counts each op per axis; an empty record is the quiet
    info line (the JAX package's key and severity)."""
    _, a = _pair("psum", ("data",), "float32", 4)
    _, b = _pair("all_gather", ("model",), "float32", 4)
    f = spmdlint.sequence_summary([a, a, b])
    assert (f.key, f.severity) == ("spmd_collectives", "info")
    assert "data: all_reduce x2" in f.message \
        and "model: all_gather x1" in f.message
    assert (spmdlint.sequence_summary([]).key,
            jlint.sequence_summary([]).key) == ("spmd_collectives",) * 2


# -------------------------------------------------------- the record

def test_collective_record_in_call_order():
    """On a virtual data:2,pipe:2,model:2 mesh the mesh module's calls
    are recorded in call order (the reduction's wire dtype, a handoff on
    the pipe axis); a call over an axis of size 1 or one the mesh lacks
    issues nothing and is not recorded, nor is anything outside the
    block."""
    mesh = meshlib.virtual_mesh(meshlib.MeshSpec(
        {"data": 2, "pipe": 2, "model": 2, "seq": 1}), torch.device("cpu"))
    x = torch.zeros(8, 4)
    meshlib.all_reduce(x, mesh, "data")
    with meshlib.recording() as rec:
        meshlib.all_reduce(x, mesh, "data", dtype=torch.bfloat16)
        meshlib.all_gather(x, mesh, "model")
        meshlib.ring_shift(x, mesh, "seq")
        meshlib.all_reduce(x, mesh, "expert")
        meshlib.handoff(mesh, "pipe", [(1, [x])], [(-1, [((8, 4),
                                                          torch.float32)])])
        meshlib.all_reduce(x, mesh, ("pipe", "data"))
    assert rec == [("all_reduce", ("data",), "bfloat16", 32),
                   ("all_gather", ("model",), "float32", 32),
                   ("handoff", ("pipe",), "float32", 32),
                   ("all_reduce", ("pipe", "data"), "float32", 32)]
    ops, findings = [], []
    spmdlint.collective_walk(rec, ops, findings)
    assert [op.prim for op in ops] == ["all_reduce", "all_gather",
                                       "handoff", "all_reduce"]
    assert ops[0].nbytes == 64 and not findings
    assert not spmdlint.axis_findings(ops, dict(mesh.axes))


# ------------------------------------------------------------ dtype flow

def _fx(fn, *args):
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn)(*args)


def test_dtype_flow_cast_roundtrip_matches_jax():
    gm = _fx(lambda x: x.to(torch.bfloat16).to(torch.float32) + 1.0,
             torch.zeros(4))
    closed = jax.make_jaxpr(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32) + 1.0)(
            jnp.zeros((4,), jnp.float32))
    got = _keys(spmdlint.dtype_flow_findings(gm))
    assert got == _keys(jlint.dtype_flow_findings(closed))
    assert ("spmd_cast_roundtrip", "warn") in got


@pytest.mark.parametrize("case", ["downcast", "native", "shallow"])
def test_dtype_flow_bf16_deep_sum_severities_match_jax(case):
    """A deep sum fed by an f32 downcast is an error, a native bf16 one a
    warning, a shallow one quiet, as in the JAX package."""
    n = 64 if case == "shallow" else 8192
    if case == "downcast":
        gm = _fx(lambda x: x.to(torch.bfloat16).sum(0), torch.zeros(n))
        closed = jax.make_jaxpr(lambda x: lax.reduce_sum_p.bind(
            x.astype(jnp.bfloat16), axes=(0,)))(jnp.zeros((n,), jnp.float32))
    else:
        gm = _fx(lambda x: x.sum(0), torch.zeros(n, dtype=torch.bfloat16))
        closed = jax.make_jaxpr(lambda x: lax.reduce_sum_p.bind(
            x, axes=(0,)))(jnp.zeros((n,), jnp.bfloat16))
    assert _keys(spmdlint.dtype_flow_findings(gm)) \
        == _keys(jlint.dtype_flow_findings(closed))


def test_dtype_flow_deep_bf16_matmul_is_advisory():
    """A bf16 matmul contracting more than 16384 is one info finding."""
    gm = _fx(lambda a, b: a @ b, torch.zeros(2, 20000, dtype=torch.bfloat16),
             torch.zeros(20000, 3, dtype=torch.bfloat16))
    assert _keys(spmdlint.dtype_flow_findings(gm)) \
        == [("spmd_bf16_dot", "info")]


# ------------------------------------------------ fixtures, through the CLI

class _F32WireLayer(Layer):
    """A large f32 sum over the data axis (against a declared bf16
    wire)."""

    type_names = ("f32wire_test",)

    def infer_shapes(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if ctx.mesh is None:
            return [x]
        s = meshlib.all_reduce(x.float().clone(), ctx.mesh, "data")
        return [x + s.mean() * 0.0]


class _Bf16AccLayer(Layer):
    """A deliberate f32 -> bf16 downcast feeding a deep sum."""

    type_names = ("bf16acc_test",)

    def infer_shapes(self, in_shapes):
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        s = x.to(torch.bfloat16).sum()
        return [x + s.float() * 0.0]


class _BadOptUpdater(updlib.SGDUpdater):
    """Momentum state handed back as a new bf16 tensor instead of
    updated in place: two copies live across the step."""

    name = "badopt"

    def apply(self, p, g, state, hyper, epoch, fused=False):
        out = super().apply(p, g, state, hyper, epoch, fused)
        state["m"] = state["m"].to(torch.bfloat16)
        return out


FIXTURES = (_F32WireLayer, _Bf16AccLayer)


@pytest.fixture
def _fixture_registry():
    for cls in FIXTURES:
        layer_registry.register(cls)
    updlib._UPDATERS["badopt"] = _BadOptUpdater()
    areg.global_scope.cache_clear()
    areg.layer_scope.cache_clear()
    yield
    for cls in FIXTURES:
        for name in cls.type_names:
            layer_registry._REGISTRY.pop(name, None)
    updlib._UPDATERS.pop("badopt", None)
    areg.global_scope.cache_clear()
    areg.layer_scope.cache_clear()


def _run_check_cli(tmp_path, conf_text, name="fixture.conf"):
    """The port's task = check CLI on a written conf: (exit code, the
    findings of its one ``check`` record)."""
    from cxxnet_tpu_torch.main import LearnTask
    conf = tmp_path / name
    conf.write_text(conf_text)
    sink = tmp_path / f"{name}.jsonl"
    rc = LearnTask().run([str(conf), "task=check", "silent=1",
                          f"metrics_sink=jsonl:{sink}"])
    recs = [json.loads(line) for line in sink.read_text().splitlines()]
    (check,) = [r for r in recs if r["kind"] == "check"]
    return rc, check["findings"]


def _spmd_ids(findings, severity=None):
    return {f["key"] for f in findings if f.get("scope") == "spmd"
            and (severity is None or f["severity"] == severity)}


_BODY = ("layer[+1] = fullc\n  nhidden = 4\n"
         "layer[+0] = softmax\nnetconfig=end\n")


def test_fixture_bf16_deep_accumulation(tmp_path, _fixture_registry):
    rc, findings = _run_check_cli(tmp_path, (
        "netconfig=start\nlayer[+1] = bf16acc_test\n" + _BODY
        + "input_shape = 1,1,8192\nbatch_size = 8\ndev = cpu\n"))
    assert rc == 1
    assert _spmd_ids(findings, "error") == {"spmd_bf16_acc"}


def test_fixture_f32_wire_despite_bf16_config(tmp_path, _fixture_registry):
    rc, findings = _run_check_cli(tmp_path, (
        "netconfig=start\nlayer[+1] = f32wire_test\n" + _BODY
        + "input_shape = 1,1,8192\nbatch_size = 8\n"
        "dev = cpu:0-1\nmesh = data:2\ndp_reduce_dtype = bf16\n"))
    assert rc == 1
    assert _spmd_ids(findings, "error") == {"spmd_f32_wire"}


def test_fixture_replaced_opt_leaf(tmp_path, _fixture_registry):
    """An optimizer-state leaf the step replaces is ``spmd_undonated``,
    naming the tree, as the JAX package's undonated leaf is."""
    rc, findings = _run_check_cli(tmp_path, (
        "netconfig=start\n" + _BODY + "updater = badopt\n"
        "input_shape = 1,1,8\nbatch_size = 8\ndev = cpu\n"))
    assert rc == 1
    assert _spmd_ids(findings, "error") == {"spmd_undonated"}
    (und,) = [f for f in findings if f["key"] == "spmd_undonated"]
    assert "opt_state" in und["message"]


def test_spmd_check_key_disables_the_pass(tmp_path, _fixture_registry):
    rc, findings = _run_check_cli(tmp_path, (
        "netconfig=start\nlayer[+1] = bf16acc_test\n" + _BODY
        + "input_shape = 1,1,8192\nbatch_size = 8\ndev = cpu\n"
        "spmd_check = 0\n"))
    assert rc == 0
    assert not _spmd_ids(findings)


def test_run_check_spmd_emits_summary_infos():
    """MNIST.conf: the census and the in-place audit (every leaf kept),
    both info; ``spmd_check = 0`` quiet."""
    pairs = parse_config_file(os.path.join(REPO, "example", "MNIST",
                                           "MNIST.conf"))
    findings, code = run_check(pairs)
    assert code == 0
    spmd = {f.key: f for f in findings if f.scope == "spmd"}
    assert set(spmd) == {"spmd_collectives", "spmd_donation"}
    assert "8/8 state leaves updated in place" in spmd["spmd_donation"].message
    quiet, code = run_check(pairs + [("spmd_check", "0")])
    assert code == 0 and not [f for f in quiet if f.scope == "spmd"]


@pytest.mark.parametrize("conf,census", [
    ("example/MNIST/mesh.conf", "model: all_gather"),
    ("example/LM/pipeline_lm.conf", "pipe: broadcast x1, handoff x16"),
])
def test_mesh_conf_census_sees_the_collectives(conf, census):
    """The census of a mesh conf's traced step: mesh.conf's model-axis
    gathers; pipeline_lm.conf's stage handoffs (stage 0 of 2: 8
    microbatches forward), the (pipe, data) gradient reductions and the
    model-axis gathers of fullc_gather; no error."""
    findings, code = run_check(parse_config_file(os.path.join(REPO, conf)))
    assert code == 0, [f.format() for f in findings
                       if f.severity == "error"]
    (c,) = [f for f in findings if f.key == "spmd_collectives"]
    assert census in c.message
    if "pipeline" in conf:
        assert "pipe,data: all_reduce" in c.message
        assert "model: all_gather" in c.message


PIPE_NET = ("netconfig=start\nlayer[+1] = fullc\n  nhidden = 256\n"
            "layer[+1] = relu\nlayer[+1] = fullc\n  nhidden = 256\n"
            "layer[+1] = relu\nlayer[+1] = fullc\n  nhidden = 4\n"
            "layer[+0] = softmax\nnetconfig=end\ninput_shape = 1,1,128\n"
            "batch_size = 8\n")


def test_spmd_lint_on_a_pipe_mesh_sees_bf16_bucket_wire():
    """A data:2,pipe:2 net (128 KiB weights) at a bf16 wire under
    dp_overlap = 1: the 1F1B bucket reductions over (pipe, data) go out
    in bf16 (no spmd_f32_wire); under GPipe, whose reduction stays whole
    and float32, the declared wire is an error."""
    conf = PIPE_NET + ("mesh = data:2,pipe:2\ndev = cpu:0-3\n"
                       "dp_overlap = 1\ndp_reduce_dtype = bf16\n"
                       "dp_bucket_mb = 0.1\n")
    ok, code = run_check(parse_config_string(
        conf + "pipe_schedule = 1f1b\n"))
    assert code == 0, [f.format() for f in ok if f.severity == "error"]
    (c,) = [f for f in ok if f.key == "spmd_collectives"]
    assert "pipe,data: all_reduce" in c.message
    bad, code = run_check(parse_config_string(
        conf + "pipe_schedule = gpipe\n"))
    assert code == 1
    assert {f.key for f in bad if f.severity == "error"} == {"spmd_f32_wire"}


def test_check_is_device_free_on_a_pipe_mesh():
    """The check of a pipe mesh conf builds nothing on a device and
    issues no collective: it runs here without a process group.  Stage
    0 of 2 sends 4 microbatches forward (two tensors each: the
    activation and the aux accumulator), the whole-tree reduction sums
    its 4 leaves over pipe and the loss comes from the last stage."""
    import torch.distributed as dist
    findings, code = run_check(parse_config_string(
        PIPE_NET + "mesh = pipe:2\ndev = cpu:0-1\n"))
    assert code == 0 and not dist.is_initialized()
    (c,) = [f for f in findings if f.key == "spmd_collectives"]
    assert c.message.endswith(
        "pipe: all_reduce x6, broadcast x1, handoff x8"), c.message

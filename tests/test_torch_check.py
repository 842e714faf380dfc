"""The port's config analysis plane against the JAX package, on the CPU.

* Registry: every key both packages declare has the same ``KeySpec``
  (name, kind, choices, lo, hi), scope by scope (global, each layer
  type, each iterator stage); the JAX package's keys the port lacks are
  exactly the ``torch`` plugin's (none at global scope).
* Lint: the config-pair cases of tests/test_analysis.py and the
  ``_mem_rules`` cases of tests/test_memory.py, and every example conf,
  through both packages' ``conflint.lint_pairs``: the findings'
  (severity, key, scope, message, suggestion) are equal, in order, but
  for the by-design differences of ``PORT_ONLY`` and ``REWORDED`` (what
  the port refuses at run time; the card's names), which each case
  lists.
* Models: ``costmodel.layer_costs``, ``memmodel.layer_mem`` and
  ``memmodel.totals`` equal the JAX package's to the flop and the byte
  on MNIST_CONV.conf and a two-layer packed LM (weights carried across),
  for a port trainer built on ``meta``, on the CPU before its first
  update and with its optimizer state; ``preflight`` gives the same
  findings against the same capacity.
* ``task = check`` through the CLI: exit 0 / 1, "did you mean", one
  ``check`` record and no ``run`` header; the traced pass touches no
  CUDA state; nothing of the process's state moves.
* ``strict_config``: the JAX package's four tests, mirrored, and a net
  built under it warning once a (type, key), as the JAX package does.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.analysis import conflint as jconflint  # noqa: E402
from cxxnet_tpu.analysis import costmodel as jcost  # noqa: E402
from cxxnet_tpu.analysis import memmodel as jmem  # noqa: E402
from cxxnet_tpu.analysis import registry as jreg  # noqa: E402
from cxxnet_tpu.io import factory as jfactory  # noqa: E402
from cxxnet_tpu.layers import registry as jlayers  # noqa: E402
from cxxnet_tpu.utils.config import (  # noqa: E402
    parse_config_file as jparse_file, parse_config_string as jparse)
from cxxnet_tpu_torch.analysis import (  # noqa: E402
    conflint, costmodel, memmodel, registry, run_check)
from cxxnet_tpu_torch.layers import base as layer_base  # noqa: E402
from cxxnet_tpu_torch.layers import registry as layer_registry  # noqa: E402
from cxxnet_tpu_torch.utils.config import (parse_config_file,  # noqa: E402
                                           parse_config_string)

EXAMPLES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "example", "**", "*.conf"), recursive=True))

#: the JAX package's keys the port does not declare (none since the moe
#: layer came with the expert axis)
JAX_ONLY_GLOBAL: set = set()
JAX_ONLY_LAYER_TYPES: dict = {}
#: the port's own keys: serve_gen_prompt_doc (serve/__init__.py)
PORT_ONLY_GLOBAL = {"serve_gen_prompt_doc"}


@pytest.fixture(autouse=True)
def _restore_strict():
    strict = layer_base.strict_config_enabled()
    yield
    layer_base.set_strict_config(strict)


# ------------------------------------------------------------- registry

def _specs(scope):
    out = {}
    for name, specs in scope._exact.items():
        out[name] = sorted({(s.kind, s.choices, s.lo, s.hi) for s in specs})
    for _, s in scope._patterns:
        out.setdefault(s.name, []).append((s.kind, s.choices, s.lo, s.hi))
    return {k: sorted(set(v)) for k, v in out.items()}


def test_global_scope_matches_jax():
    j, p = _specs(jreg.global_scope()), _specs(registry.global_scope())
    assert set(j) - set(p) == JAX_ONLY_GLOBAL
    assert set(p) - set(j) == PORT_ONLY_GLOBAL
    assert {k: j[k] for k in set(j) & set(p)} \
        == {k: p[k] for k in set(j) & set(p)}


@pytest.mark.parametrize("type_name", sorted(jlayers._REGISTRY))
def test_layer_scope_matches_jax(type_name):
    """Each layer type of the JAX package (moe included): the same keys
    in the port."""
    j = jreg.layer_scope(type_name)
    p = registry.layer_scope(type_name)
    if type_name in JAX_ONLY_LAYER_TYPES:
        assert p is None and layer_registry.is_not_ported(type_name)
        assert JAX_ONLY_LAYER_TYPES[type_name] <= set(_specs(j))
        return
    assert _specs(p) == _specs(j)


@pytest.mark.parametrize("iter_type", sorted(jfactory.iter_type_names()))
def test_iterator_stage_keys_match_jax(iter_type):
    from cxxnet_tpu_torch.io import factory
    j = jfactory.iter_stage_classes(iter_type) or ()
    p = factory.iter_stage_classes(iter_type) or ()
    assert [c.__name__ for c in p] == [c.__name__ for c in j]
    for jc, pc in zip(j, p):
        assert [(s.name, s.kind, s.choices, s.lo, s.hi)
                for s in pc.config_keys] \
            == [(s.name, s.kind, s.choices, s.lo, s.hi)
                for s in jc.config_keys]


# ----------------------------------------------------------------- lint

#: port findings the JAX package does not give, by design, each with
#: the rule that makes them
PORT_ONLY = {
    "not ported": lambda f: (f.severity == "error"
                             and "not ported to cxxnet_tpu_torch yet"
                             in f.message),
    "TPU selector": lambda f: (f.severity == "warn" and f.key == "mem_chip"
                               and "'v5e' names no known chip"
                               in f.message),
}
#: the JAX package's words -> the port's, in findings both give
REWORDED = (("(set mem_chip, e.g. v5e)", "(set mem_chip, e.g. h100)"),
            ("persist; XLA may keep more, so", "persist; the allocator "
             "may keep more, so"))

MLP_NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 24
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 5
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,16
eta = 0.1
"""

#: (id, config text, the keys of its by-design port-only findings, in
#: order): tests/test_analysis.py's config-pair cases (:78-436, and the
#: CLI typo of :603-606) and tests/test_memory.py's _mem_rules ones
#: (:304-319)
CASES = [
    ("global_typo", "batch_size = 8\ndp_buckt_mb = 8\n", []),
    ("layer_typo", "netconfig=start\nlayer[+1] = conv\n  nchanel = 32\n"
     "  kernel_size = 3\nnetconfig=end\ninput_shape = 3,8,8\n"
     "batch_size = 4\n", []),
    ("iter_typo_misplaced", "data = train\niter = mnist\n  path_imgg = x.gz\n"
     "  buffer_size = 4\niter = end\n", []),
    ("unknown_types", "data = train\niter = mnsit\niter = end\n"
     "netconfig=start\nlayer[+1] = fullcc\nnetconfig=end\n", []),
    ("type_violation", "batch_size = lots\n", []),
    ("enum_violation", "pool_bwd = zzz\n", []),
    ("range_violation", "netconfig=start\nlayer[+1] = fullc\n  nhidden = 4\n"
     "layer[+0] = dropout\n  threshold = 1.5\nnetconfig=end\n"
     "input_shape = 1,1,4\nbatch_size = 2\n", []),
    ("bad_metric", "metric = errr\n", []),
    ("monitor_multi_step", "monitor = 1\nmulti_step = 4\n", []),
    ("multi_step_update_period", "multi_step = 4\nupdate_period = 2\n", []),
    ("dp_overlap_batch_split", "dp_overlap = 1\nbatch_split = 2\n"
     "batch_size = 8\n", []),
    ("dp_reduce_at_apply", "dp_overlap = 1\ndp_reduce_at = apply\n",
     []),
    ("dp_reduce_at_apply_quiet", "dp_overlap = 1\ndp_reduce_at = apply\n"
     "update_period = 4\n", []),
    ("mesh_unknown_axis", "mesh = data:2,modle:2\n", []),
    ("mesh_product", "mesh = data:2,model:2\ndev = cpu:0-2\n",
     []),
    ("mesh_product_ok", "mesh = data:2,model:2\ndev = cpu:0-3\n"
     "fullc_gather = 1\n", []),
    ("mesh_product_dev_tpu", "mesh = data:2,model:2\ndev = tpu\n"
     "fullc_gather = 1\n", []),
    ("mesh_batch", "mesh = data:4\nbatch_size = 10\n", []),
    ("mesh_batch_ok", "mesh = data:4\nbatch_size = 16\n", []),
    ("mesh_dead_model_axis", "mesh = data:2,model:2\n", []),
    ("mesh_model_axis_gather", "mesh = data:2,model:2\nfullc_gather = 1\n",
     []),
    ("dp_overlap_seq", "dp_overlap = 1\nmesh = data:2,seq:2\n",
     []),
    ("dp_overlap_no_data", "dp_overlap = 1\nmesh = model:4\n"
     "fullc_gather = 1\n", []),
    ("dp_overlap_reduce_at", "dp_overlap = 1\nmesh = data:2,model:2\n"
     "fullc_gather = 1\nupdate_period = 2\ndp_reduce_at = apply\n",
     []),
    ("dp_overlap_moe", "dp_overlap = 1\nmesh = data:2,model:2\n"
     "netconfig=start\nlayer[+1] = moe\n  num_expert = 4\n  nhidden = 8\n"
     "netconfig=end\ninput_shape = 1,1,8\n",
     []),
    ("dp_overlap_quiet", "dp_overlap = 1\nmesh = data:2,model:2\n"
     "fullc_gather = 1\n", []),
    ("pipe_shallow", "mesh = pipe:4\ndev = cpu:0-3\nnetconfig=start\n"
     "layer[+1] = fullc\n  nhidden = 4\nnetconfig=end\n"
     "input_shape = 1,1,8\nbatch_size = 4\n", []),
    ("pipe_no_net", "mesh = pipe:2\ndev = cpu:0-1\n", []),
    ("pipe_deep", "mesh = pipe:2\ndev = cpu:0-1\nnetconfig=start\n"
     "layer[+1] = fullc\n  nhidden = 8\nlayer[+1] = relu\n"
     "layer[+1] = fullc\n  nhidden = 4\nlayer[+0] = softmax\n"
     "netconfig=end\ninput_shape = 1,1,8\nbatch_size = 4\n",
     []),
    ("pipe_dp_overlap_gpipe", "dp_overlap = 1\nmesh = data:2,pipe:2\n"
     "dev = cpu:0-3\n", []),
    ("pipe_dp_overlap_1f1b", "dp_overlap = 1\nmesh = data:2,pipe:2\n"
     "dev = cpu:0-3\npipe_schedule = 1f1b\n", []),
    ("seq_dp_overlap", "dp_overlap = 1\nmesh = data:2,seq:2\n"
     "dev = cpu:0-3\n", []),
    ("pipe_ragged", "mesh = pipe:2\ndev = cpu:0-1\npipe_microbatch = 3\n"
     "batch_size = 6\n", []),
    ("pipe_defaulted", "mesh = pipe:2\ndev = cpu:0-1\nbatch_size = 6\n",
     []),
    ("pipe_schedule_no_pipe", "mesh = data:2\ndev = cpu:0-1\n"
     "pipe_schedule = 1f1b\n", []),
    ("pipe_schedule_no_mesh", "pipe_schedule = 1f1b\n", []),
    ("pipe_remat", "mesh = pipe:2\ndev = cpu:0-1\nremat = 2\n",
     []),
    ("pipe_clean", "mesh = data:2,pipe:2\ndev = cpu:0-3\n"
     "pipe_schedule = 1f1b\npipe_microbatch = 4\nbatch_size = 16\n",
     []),
    ("dp_reduce_dtype", "dp_reduce_dtype = bf16\n", []),
    ("dp_reduce_dtype_quiet", "dp_overlap = 1\ndp_reduce_dtype = bf16\n",
     []),
    ("monitor_nan", "monitor_nan = fatal\n", []),
    ("batch_split_divisibility", "batch_size = 10\nbatch_split = 4\n", []),
    ("engine_options_net", "dp_overlap = 1\nfused_update = 1\n"
     "netconfig=start\nlayer[+1] = fullc\n  nhidden = 4\n"
     "layer[+0] = softmax\nnetconfig=end\ninput_shape = 1,1,8\n"
     "batch_size = 4\n", []),
    ("pallas_ln_bf16", "dtype = bfloat16\nnetconfig=start\n"
     "layer[+1] = layernorm\nnetconfig=end\ninput_shape = 1,8,16\n"
     "batch_size = 2\n", []),
    ("pallas_ln_no_layernorm", "dtype = bfloat16\n", []),
    ("pallas_ln_escaped", "dtype = bfloat16\npallas_ln = x\n"
     "netconfig=start\nlayer[+1] = layernorm\nnetconfig=end\n"
     "input_shape = 1,8,16\nbatch_size = 2\n", []),
    ("pred_task", "task = pred\n", []),
    ("structural", "netconfig=start\nlayer[nosuch->out] = fullc\n"
     "  nhidden = 4\nnetconfig=end\ninput_shape = 1,1,4\nbatch_size = 2\n",
     []),
    ("mem_keys_without_mem_check", MLP_NET + "batch_size = 8\n"
     "mem_margin_pct = 5\n", []),
    ("mem_check_off_task", MLP_NET + "batch_size = 8\ntask = pred\n"
     "model_in = x\nmem_check = 1\nmem_chip = v5e\n", ["mem_chip"]),
    ("mem_check_remat", MLP_NET + "batch_size = 8\nremat = 2\n"
     "mem_check = 1\nmem_chip = v5e\n", ["mem_chip"]),
]

#: the by-design port-only findings of each example conf, by key (none:
#: the port runs every example conf's mesh)
EXAMPLE_PORT_ONLY = {}


def _norm(f):
    return (f.severity, f.key, f.scope, f.message, f.suggestion)


def _reword(t):
    sev, key, scope, msg, sugg = t
    for old, new in REWORDED:
        msg = msg.replace(old, new)
    return (sev, key, scope, msg, sugg)


def _lint_both(jpairs, ppairs, path=""):
    """(the JAX package's findings reworded, the port's other findings,
    the port's by-design findings)."""
    assert list(map(tuple, jpairs)) == list(map(tuple, ppairs))
    jf = [_reword(_norm(f)) for f in jconflint.lint_pairs(jpairs, path)]
    pf = conflint.lint_pairs(ppairs, path)
    by_design = [f for f in pf
                 if any(rule(f) for rule in PORT_ONLY.values())]
    rest = [_norm(f) for f in pf if f not in by_design]
    return jf, rest, by_design


@pytest.mark.parametrize("text,port_only", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_lint_matches_jax(text, port_only):
    jf, rest, by_design = _lint_both(jparse(text), parse_config_string(text))
    assert rest == jf
    assert [f.key for f in by_design] == port_only


@pytest.mark.parametrize("conf", EXAMPLES)
def test_example_conf_lint_matches_jax(conf):
    path = os.path.join(REPO, conf)
    jf, rest, by_design = _lint_both(jparse_file(path),
                                     parse_config_file(path), path)
    assert rest == jf
    assert [f.key for f in by_design] == EXAMPLE_PORT_ONLY.get(conf, [])
    # an example conf errs on the port only where the port refuses it
    assert not [f for f in rest if f[0] == "error"]


def test_not_ported_findings_use_the_runtime_words(tmp_path, monkeypatch):
    """A not-ported finding is the ValueError the runtime raises for the
    same key, word for word (a layer type of ``NOT_PORTED``: empty since
    every layer is ported, so one is listed here for the check).  The
    data-parallel plane's keys, the seq, expert and pipe axes, the moe
    layer, and several device ids for ``pred`` / ``pred_raw`` /
    ``extract`` / ``serve`` (they run on a mesh) are no finding: on
    those pairs the port's findings are the JAX package's."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    ported = [("mesh", "data:2,model:2"), ("dev", "gpu:0-3"),
              ("mesh", "data:2,seq:2"), ("mesh", "data:2,expert:2"),
              ("mesh", "data:2,pipe:2"), ("pipe_schedule", "1f1b"),
              ("shard_opt_state", "1"), ("update_on_server", "1"),
              ("fullc_gather", "1"), ("test_on_server", "1"),
              ("dp_overlap", "1"), ("dp_reduce_dtype", "bf16")]
    assert not [f for f in conflint.lint_pairs(ported)
                if f.severity == "error"]
    NetTrainer().set_param("mesh", "data:2,pipe:2")
    for task in ("pred", "pred_raw", "extract", "serve"):
        for dev in ("cpu:0-1", "gpu:0-1"):
            text = f"task = {task}\ndev = {dev}\n"
            jf, rest, by_design = _lint_both(jparse(text),
                                             parse_config_string(text))
            assert rest == jf and not by_design, (task, dev)
            assert not [f for f in rest if f[1] == "dev"], (task, dev)
    conf = tmp_path / "pred.conf"
    conf.write_text("task = pred\ndev = gpu:0-1\n")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LearnTask().run([str(conf)])
    monkeypatch.setattr(layer_registry, "NOT_PORTED", ("moe",))
    pairs = parse_config_string("netconfig=start\nlayer[+1] = moe\n"
                                "  num_expert = 4\nnetconfig=end\n")
    (found,) = [f.message for f in conflint.lint_pairs(pairs)
                if f.severity == "error"]
    with pytest.raises(ValueError) as ei:
        layer_registry.create_layer("moe")
    assert str(ei.value) == found
    monkeypatch.undo()
    assert layer_registry.create_layer("moe").type_names == ("moe",)
    assert not [f for f in conflint.lint_pairs(pairs)
                if f.severity == "error"]


def test_card_selectors():
    assert costmodel.resolve_chip("h100") == costmodel.H100
    assert costmodel.resolve_chip("NVIDIA H100 80GB HBM3") == costmodel.H100
    for sel in ("v5e", "tpu v4", "gpu", "", "h10"):
        assert costmodel.resolve_chip(sel) is None
    assert costmodel.hbm_bytes(costmodel.H100) == 80e9
    assert costmodel.peak_flops("cpu") is None


# --------------------------------------------------------------- models

def _lm_net():
    from cxxnet_tpu_torch.models import transformer
    return transformer(vocab=64, seq=16, dim=16, nlayer=2, nhead=2,
                       packed=True) \
        + "batch_size = 2\ndtype = bfloat16\nupdater = adam\neta = 0.01\n"


def _mnist_conv():
    return open(os.path.join(REPO, "example", "MNIST",
                             "MNIST_CONV.conf")).read()


NETS = {"mnist_conv": _mnist_conv, "packed_lm": _lm_net}


def _pair(text, variant):
    """(JAX trainer, port trainer): the port's ``meta`` build, or a CPU
    build from the JAX trainer's weights before its first update
    (``cpu``) or with its optimizer state made (``cpu_state``)."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JT
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    import jax
    keys = [("dev", "cpu"), ("silent", "1"), ("eval_train", "0")]
    jt = JT()
    for k, v in jparse(text) + keys:
        if k != "metrics_sink":
            jt.set_param(k, v)
    jt.init_model()
    tt = NetTrainer()
    for k, v in parse_config_string(text) + keys:
        tt.set_param(k, v)
    if variant == "meta":
        tt.init_model(torch.device("meta"))
        assert all(p.is_meta for g in tt.params.values()
                   for p in g.values())
        return jt, tt
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    if variant == "cpu_state":
        tt._ensure_opt_state()
    return jt, tt


@pytest.mark.parametrize("net", sorted(NETS))
def test_layer_costs_match_jax(net):
    jt, tt = _pair(NETS[net](), "meta")
    assert costmodel.layer_costs(tt.net) == jcost.layer_costs(jt.net)
    assert costmodel.layer_costs(tt.net, train=False) \
        == jcost.layer_costs(jt.net, train=False)


@pytest.mark.parametrize("variant", ["meta", "cpu", "cpu_state"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_memory_model_matches_jax(net, variant):
    jt, tt = _pair(NETS[net](), variant)
    assert memmodel.param_rows(tt) == jmem.param_rows(jt)
    lm = memmodel.layer_mem(tt)
    assert lm == jmem.layer_mem(jt)
    assert memmodel.totals(tt, lm) == jmem.totals(jt)
    assert all(r["opt_bytes"] for r in memmodel.param_rows(tt).values())


@pytest.mark.parametrize("keys", [(("remat", "2"),), (("batch_split", "2"),),
                                  (("update_period", "3"),)],
                         ids=["remat", "batch_split", "update_period"])
def test_memory_totals_corrections_match_jax(keys):
    text = _lm_net() + "".join(f"{k} = {v}\n" for k, v in keys)
    jt, tt = _pair(text, "meta")
    assert memmodel.totals(tt) == jmem.totals(jt)


@pytest.mark.parametrize("keys", [
    (("mesh", "data:4"),),
    (("mesh", "data:4"), ("shard_opt_state", "1")),
    (("mesh", "data:2,model:2"), ("fullc_gather", "1")),
    (("mesh", "data:2,model:2"), ("fullc_gather", "1"),
     ("shard_opt_state", "1"))], ids=["data", "zero", "model", "both"])
def test_memory_model_on_a_mesh_matches_jax(keys):
    """On a cpu:0-3 mesh both models count what one device holds: a ZeRO
    slice of the optimizer state, a model shard of a fullc weight, the
    data axis's share of the activations; the pre-flight's remediations
    (ZeRO among them) agree."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JT
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    text = _lm_net().replace("batch_size = 2", "batch_size = 8")
    pairs = jparse(text) + [("dev", "cpu:0-3"), ("silent", "1"),
                            ("eval_train", "0")] + list(keys)
    jt, tt = JT(), NetTrainer()
    for k, v in pairs:
        jt.set_param(k, v)
        tt.set_param(k, v)
    jt.init_model()
    tt.init_model(torch.device("meta"))
    assert memmodel.param_rows(tt) == jmem.param_rows(jt)
    assert memmodel.layer_mem(tt) == jmem.layer_mem(jt)
    tot = memmodel.totals(tt)
    assert tot == jmem.totals(jt)
    assert memmodel._remediations(tt, tot) == jmem._remediations(
        jt, jmem.totals(jt))


@pytest.mark.parametrize("frac", [2.0, 0.95, 0.5],
                         ids=["over", "margin", "fits"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_preflight_matches_jax_at_one_capacity(net, frac, monkeypatch):
    """Both pre-flights against one capacity (the tables patched; the
    estimate ``frac`` of it): error over it, warn inside the 10% margin,
    info below; the same words but for the card's name."""
    jt, tt = _pair(NETS[net](), "meta")
    cap = jmem.totals(jt)["est_peak_bytes"] / frac
    monkeypatch.setattr(jcost, "HBM_BYTES", {"TPU v5e": cap})
    monkeypatch.setattr(costmodel, "HBM_BYTES", {costmodel.H100: cap})
    jf = jmem.preflight(jt, [("mem_check", "1"), ("mem_chip", "v5e")])
    pf = memmodel.preflight(tt, [("mem_check", "1"), ("mem_chip", "h100")])
    assert [f.severity for f in pf] == [f.severity for f in jf] \
        == [{2.0: "error", 0.95: "warn", 0.5: "info"}[frac]]
    assert [_norm(f) for f in pf] == [
        _norm(f)[:3] + (f.message.replace("TPU v5e", costmodel.H100),
                        f.suggestion) for f in jf]


# ------------------------------------------------------- task = check

def test_task_check_cli_exit_codes_and_record(tmp_path, capsys):
    from cxxnet_tpu_torch.main import LearnTask
    conf = os.path.join(REPO, "example", "MNIST", "MNIST_CONV.conf")
    sink = tmp_path / "m.jsonl"
    assert LearnTask().run([conf, "task=check", "silent=1",
                            f"metrics_sink=jsonl:{sink}"]) == 0
    recs = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["check"]
    assert recs[0]["n_error"] == 0 and recs[0]["config"] == conf
    capsys.readouterr()
    sink2 = tmp_path / "m2.jsonl"
    assert LearnTask().run([conf, "task=check", "num_rund=4",
                            f"metrics_sink=jsonl:{sink2}"]) == 1
    assert "did you mean 'num_round'" in capsys.readouterr().err
    recs = [json.loads(line) for line in sink2.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["check"] and recs[0]["n_error"] == 1
    (bad,) = [f for f in recs[0]["findings"] if f["severity"] == "error"]
    assert bad["key"] == "num_rund" and bad["suggestion"] == "num_round"


def test_task_check_refused_config_is_a_finding(tmp_path, monkeypatch):
    """test_on_server = 1 runs (it is the JAX package's finding-free
    key); a config the port refuses at run time (here a layer type
    listed as not ported) is a finding of the check pass, not a raise;
    a pipe mesh axis is taken, and several device ids for task = pred
    (which run on a mesh) are no finding."""
    from cxxnet_tpu_torch.analysis import run_check
    from cxxnet_tpu_torch.main import LearnTask
    conf = os.path.join(REPO, "example", "MNIST", "MNIST.conf")
    task = LearnTask()
    assert task.run([conf, "task=check", "test_on_server=1"]) == 0
    assert not [f for f in task.last_check if f.severity == "error"]
    task = LearnTask()
    assert task.run([conf, "task=check", "mesh=data:2,pipe:2",
                     "dev=cpu:0-3"]) == 0
    assert not [f for f in task.last_check if f.severity == "error"]
    findings, _ = run_check([("task", "pred"), ("dev", "cpu:0-1")])
    assert not [f for f in findings if f.key == "dev"
                or "not ported" in f.message]
    monkeypatch.setattr(layer_registry, "NOT_PORTED", ("fullc",))
    net = tmp_path / "net.conf"
    net.write_text("netconfig=start\nlayer[+1] = fullc\n  nhidden = 4\n"
                   "layer[+0] = softmax\nnetconfig=end\n"
                   "input_shape = 1,1,8\nbatch_size = 4\ndev = cpu\n"
                   "num_round = 0\nsave_model = 0\nsilent = 1\n")
    task = LearnTask()
    assert task.run([str(net), "task=check"]) == 1
    (layer,) = [f for f in task.last_check if f.severity == "error"]
    with pytest.raises(ValueError) as ei:
        LearnTask().run([str(net)])
    assert str(ei.value) == layer.message
    assert "not ported" in layer.message and layer.key.startswith("layer[")


def test_check_builds_on_meta_without_cuda(monkeypatch):
    """The traced pass of a full-width LM conf with mem_check = 1: the
    graph lint's closing info finding (its step traced on meta), the
    pre-flight's info finding, not one call into torch.cuda but torch's
    own tracer asking is_available, and no CUDA context made."""
    from cxxnet_tpu_torch.models import transformer
    touched = []
    for name in ("_lazy_init", "current_device",
                 "memory_allocated", "synchronize", "get_device_name",
                 "get_device_properties", "device_count"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: touched.append(_n))
    # is_available is watched too, but torch's own tracer may ask it: the
    # fake-tensor mode under which make_fx records each value's metadata
    # queries it on entry (FakeTensorMode.avoid_device_init).  Only a call
    # from torch's tracing modules is let through; any other is a touch
    tracer_dirs = tuple(os.path.join(os.path.dirname(torch.__file__), d)
                        + os.sep for d in ("_subclasses", "fx"))
    real_is_available = torch.cuda.is_available

    def is_available():
        caller = sys._getframe(1).f_code.co_filename
        if not caller.startswith(tracer_dirs):
            touched.append(f"is_available from {caller}")
        return real_is_available()

    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    text = (transformer(vocab=8192, seq=4096, dim=2048, nlayer=12, nhead=16,
                        packed=True)
            + "batch_size = 4\ndtype = bfloat16\nupdater = adam\n"
            "fused_update = 1\ndev = gpu\nmem_check = 1\nmem_chip = h100\n")
    findings, code = run_check(parse_config_string(text))
    assert code == 0 and not touched
    assert not torch.cuda.is_initialized()
    (mem,) = [f for f in findings if f.scope == "mem"]
    assert mem.severity == "info" and "35% full" in mem.message
    assert any(f.scope == "jaxpr" and f.severity == "info"
               and f.message.startswith("traced train step:")
               for f in findings)


def test_check_changes_no_process_state():
    """The port's engine options are each trainer's own: a checked
    config's options reach neither a trainer built before nor the
    defaults; the log's silence and strict_config are put back."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.monitor import log as mlog
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    before = NetTrainer()
    defaults = EngineOptions().snapshot()
    mlog.set_silent(0)
    layer_base.set_strict_config(False)
    text = ("pool_layout = hwcn\npallas_lrn = hwcn\nfused_update = 1\n"
            "strict_config = 1\nsilent = 1\n" + MLP_NET + "batch_size = 4\n")
    findings, code = run_check(parse_config_string(text))
    assert code == 0, [f.format() for f in findings]
    assert before.opts.snapshot() == defaults
    assert EngineOptions().snapshot() == defaults
    assert not layer_base.strict_config_enabled()


def test_check_without_net_and_build_failure():
    findings, code = run_check(parse_config_file(
        os.path.join(REPO, "example", "MNIST", "MNIST_pred.conf")))
    assert code == 0
    assert any("traced-graph lint skipped" in f.message for f in findings)
    findings, code = run_check(parse_config_string(
        MLP_NET.replace("input_shape = 1,1,16\n", "") + "batch_size = 4\n"))
    assert code == 1
    assert any(f.message.startswith("net build failed") for f in findings)


@pytest.mark.parametrize("spmd_check", [None, "0", "1"])
def test_check_explicit_spmd_check_warns_it_has_no_effect(spmd_check):
    """The SPMD deep lint runs by default and under ``spmd_check = 1``
    (its census and in-place audit, both info; exit code unchanged) and
    ``spmd_check = 0`` skips it, as in the JAX package; no "not ported"
    warning is left.  A ``mem_check = 1`` without a net warns that the
    pre-flight cannot run, and a config without a net has no SPMD
    finding."""
    extra = "" if spmd_check is None else f"spmd_check = {spmd_check}\n"
    findings, code = run_check(parse_config_string(
        MLP_NET + "batch_size = 4\n" + extra))
    assert code == 0, [f.format() for f in findings]
    spmd = [f for f in findings if f.scope == "spmd"]
    assert not [f for f in findings if "not ported" in f.message]
    if spmd_check == "0":
        assert not spmd
    else:
        assert [(f.severity, f.key) for f in spmd] == [
            ("info", "spmd_collectives"), ("info", "spmd_donation")]
    findings, code = run_check(parse_config_string(
        "batch_size = 4\nmem_check = 1\n" + extra))
    assert code == 0
    assert [f.message for f in findings if f.scope == "mem"] == [
        "the OOM pre-flight needs the traced-graph pass (it models the "
        "built net); this config has no netconfig block"]
    assert not [f for f in findings if f.scope == "spmd"]


# ------------------------------------------------------- strict_config

def test_strict_config_reports_unknown_layer_key(capsys):
    layer_base.set_strict_config(True)
    conflint._reported.clear()
    layer = layer_registry.create_layer("conv")
    layer.set_param("nchanel", "32")       # typo -> warn with suggestion
    layer.set_param("eta", "0.1")          # global broadcast -> silent
    layer.set_param("kernel_size", "3")    # declared -> silent
    err = capsys.readouterr().err
    assert "nchanel" in err and "nchannel" in err
    assert "eta" not in err


def test_strict_config_off_is_silent(capsys):
    layer_base.set_strict_config(False)
    conflint._reported.clear()
    layer = layer_registry.create_layer("conv")
    layer.set_param("nchanel", "32")
    assert "nchanel" not in capsys.readouterr().err


def test_strict_config_retoggle_resets_dedup(capsys):
    layer_base.set_strict_config(True)
    layer_registry.create_layer("conv").set_param("nchanel", "1")
    assert "nchanel" in capsys.readouterr().err
    layer_registry.create_layer("conv").set_param("nchanel", "1")
    assert "nchanel" not in capsys.readouterr().err  # deduped
    layer_base.set_strict_config(True)  # new toggle -> fresh window
    layer_registry.create_layer("conv").set_param("nchanel", "1")
    assert "nchanel" in capsys.readouterr().err


def test_strict_config_via_trainer_key():
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    net = NetTrainer()
    net.set_param("strict_config", "1")
    assert layer_base.strict_config_enabled()
    net.set_param("strict_config", "0")
    assert not layer_base.strict_config_enabled()


def test_strict_config_net_build_warns_as_jax(capfd):
    """A net built under strict_config = 1 with two unknown keys in one
    conv section and one in another: each package warns once a (type,
    key), the same lines."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JT
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    text = ("strict_config = 1\nnetconfig=start\n"
            "layer[+1] = conv:c1\n  nchanel = 4\n  nchannel = 4\n"
            "  kernel_size = 3\n  zzz_key = 1\n"
            "layer[+1] = conv:c2\n  nchannel = 4\n  kernel_size = 1\n"
            "  nchanel = 4\n"
            "layer[+1] = flatten\nlayer[+1] = fullc\n  nhidden = 3\n"
            "  strides = 2\nlayer[+0] = softmax\nnetconfig=end\n"
            "input_shape = 1,6,6\nbatch_size = 2\ndev = cpu\nsilent = 1\n")
    lines = []
    for make in (JT, NetTrainer):
        capfd.readouterr()
        t = make()
        for k, v in parse_config_string(text):
            t.set_param(k, v)
        t.init_model()
        lines.append([ln for ln in capfd.readouterr().err.splitlines()
                      if "strict_config" in ln])
    assert lines[1] == lines[0]
    assert len(lines[1]) == 3  # (conv, nchanel), (conv, zzz_key), strides

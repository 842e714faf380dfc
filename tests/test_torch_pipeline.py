"""The port's pipeline parallelism (``mesh = ...,pipe:K``) against the JAX
package, on the CPU.

* Toy stages through every entry point of ``parallel/pipeline.py`` on two
  gloo ranks (``pipeline_apply``, ``pipeline_apply_hetero``,
  ``pipeline_1f1b`` under both schedules, ``pipeline_1f1b_hetero``,
  ``pipeline_train_step``) against the JAX functions on a ``pipe:2`` mesh
  of host devices, from one seeded numpy input: outputs, losses and
  gradients within 1e-5 of the largest value.
* tests/test_pipeline_net.py's LeNet at ``pipe:4`` and ``data:2,pipe:2``
  under GPipe and 1F1B (4 microbatches), a moe net whose load-balance
  term crosses the stage boundary, and 1F1B under ``dp_overlap = 1``
  (several buckets a stage): the port on four spawned gloo ranks against
  the JAX package's trainer on its ``cpu:0-3`` mesh, from the JAX
  package's initial weights; per-step losses within 1e-6 relative,
  parameters within 1e-5, replicas bitwise after every step.
* Inside the port: the 1F1B first-step loss equals GPipe's bitwise and
  later ones within 1e-6; at a float32 wire the bucketed 1F1B reduction
  equals the whole-tree one bitwise; a stage holds at most ``2(S-1-s)+1``
  microbatch graphs at ``pipe_microbatch`` 8 and 16 (GPipe holds all);
  the pipelined eval forward gives the one-device values.
* A pipe run's ``.ckpt`` loads into the JAX package's trainer, bitwise.
* ``example/LM/pipeline_lm.conf`` as shipped (data:2,pipe:2,model:2,
  1F1B, ``dp_overlap = 1``, ``fullc_gather = 1``) through both CLIs on 8
  CPU ranks, only its data path overridden; the stamped
  ``pipe_bubble_frac`` and the ledger's ``pipe_bubble`` are the analytic
  ``(S-1)/(M+S-1)``.
* ``remat`` with a pipe axis and GPipe under ``dp_overlap = 1`` in the
  JAX package's words.
"""

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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dp_ranks as ranks  # noqa: E402
from cxxnet_tpu import engine  # noqa: E402
from cxxnet_tpu.io.data import DataBatch as JBatch  # noqa: E402
from cxxnet_tpu.models.zoo import lenet  # noqa: E402
from __graft_entry__ import _make_trainer  # noqa: E402

LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
TOY_TOL = 1e-5

LENET = lenet(num_class=4)
EXTRA = (("eta", "0.1"), ("momentum", "0.9"), ("silent", "1"),
         ("eval_train", "0"))
DP_OPTS = ("dp_overlap", "dp_bucket_mb", "dp_reduce_dtype")

MOE_NET = """
netconfig=start
layer[0->1] = embedding
  vocab_size = 32
  nhidden = 16
layer[1->2] = moe
  num_expert = 4
  nhidden = 32
layer[2->3] = seq_fullc
  nhidden = 32
layer[3->3] = softmax_seq
netconfig=end
label_vec[0,8) = label
input_shape = 1,1,8
updater = sgd
eta = 0.05
silent = 1
"""


DROPOUT_NET = """
netconfig=start
layer[0->1] = fullc:d_fc1
  nhidden = 32
layer[1->2] = relu
layer[2->2] = dropout
  threshold = 0.3
layer[2->3] = fullc:d_fc2
  nhidden = 32
layer[3->4] = relu
layer[4->4] = dropout
  threshold = 0.3
layer[4->5] = fullc:d_fc3
  nhidden = 4
layer[5->5] = softmax
netconfig=end
input_shape = 1,1,144
"""


def _lenet_batches(n=3, bs=16, seed=0):
    rnd = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rnd.rand(bs, 1, 28, 28).astype(np.float32)
        y = (x.mean(axis=(1, 2, 3)) > 0.5).astype(np.float32) * 2
        out.append((x, y.reshape(bs, 1), 0))
    return out


def _moe_batches(n=3, bs=16, seed=0):
    rnd = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rnd.randint(0, 32, (bs, 8)).astype(np.float32)
        out.append((toks.reshape(bs, 1, 1, 8), toks, 0))
    return out


#: (id, net, batches, mesh, extra pairs): the JAX parity cases
CASES = [
    ("pipe4_gpipe", LENET, _lenet_batches, "pipe:4",
     (("pipe_microbatch", "4"), ("pipe_schedule", "gpipe"))),
    ("pipe4_1f1b", LENET, _lenet_batches, "pipe:4",
     (("pipe_microbatch", "4"), ("pipe_schedule", "1f1b"))),
    ("dp_pipe_gpipe", LENET, _lenet_batches, "data:2,pipe:2",
     (("pipe_microbatch", "4"), ("pipe_schedule", "gpipe"))),
    ("dp_pipe_1f1b", LENET, _lenet_batches, "data:2,pipe:2",
     (("pipe_microbatch", "4"), ("pipe_schedule", "1f1b"))),
    ("dp_pipe_1f1b_overlap", LENET, _lenet_batches, "data:2,pipe:2",
     (("pipe_microbatch", "2"), ("pipe_schedule", "1f1b"),
      ("dp_overlap", "1"), ("dp_bucket_mb", "0.01"))),
    ("moe_1f1b", MOE_NET, _moe_batches, "data:2,pipe:2",
     (("pipe_microbatch", "2"), ("pipe_schedule", "1f1b"))),
]


def _jax_run(net, batches, mesh, extra):
    saved = {k: getattr(engine.opts, k) for k in DP_OPTS}
    try:
        for k, v in extra:
            if k in DP_OPTS:
                engine.opts.set(k, v)
        t = _make_trainer(net, 16, "cpu:0-3", extra=list(EXTRA) + [
            ("mesh", mesh)] + [kv for kv in extra if kv[0] not in DP_OPTS])
        init = (jax.tree.map(np.asarray, t.params),
                jax.tree.map(np.asarray, t.buffers))
        losses = []
        for data, label, _ in batches():
            t.update(JBatch(data=data, label=label,
                            index=np.arange(16, dtype=np.uint32)))
            losses.append(float(np.asarray(t._last_loss)))
        return init, losses, jax.tree.map(np.asarray, t.params)
    finally:
        for k, v in saved.items():
            engine.opts.set(k, v)


def _case(net, batches, mesh, extra, init, **kw):
    return dict(net=net, batch=16, init=init, data=batches(),
                extra=EXTRA + (("mesh", mesh),) + tuple(extra), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX cases through the JAX package, then every port case
    (those, the whole-tree twin of the bucketed run, the in-flight
    bound at 8 and 16 microbatches, the pipelined eval and a snapshot)
    through one spawned group of four gloo ranks."""
    out = tmp_path_factory.mktemp("pipe")
    jax_res, cases = {}, []
    for cid, net, batches, mesh, extra in CASES:
        jax_res[cid] = _jax_run(net, batches, mesh, extra)
        cases.append(_case(net, batches, mesh, extra, jax_res[cid][0]))
    init = jax_res["dp_pipe_1f1b_overlap"][0]
    extra = dict(CASES[4][4])
    extra["dp_overlap"] = "0"
    more = {
        "whole_tree": _case(LENET, _lenet_batches, "data:2,pipe:2",
                            tuple(extra.items()), init),
        "live8": _case(LENET, lambda: _lenet_batches(2), "pipe:4",
                       (("pipe_microbatch", "8"),
                        ("pipe_schedule", "1f1b")), init, all_ranks=True),
        "live16": _case(LENET, lambda: _lenet_batches(2), "pipe:4",
                        (("pipe_microbatch", "16"),
                         ("pipe_schedule", "1f1b")), init, all_ranks=True),
        "live16_gpipe": _case(LENET, lambda: _lenet_batches(2), "pipe:4",
                              (("pipe_microbatch", "16"),
                               ("pipe_schedule", "gpipe")), init,
                              all_ranks=True),
        "eval": _case(LENET, lambda: _lenet_batches(1), "pipe:4",
                      (("pipe_microbatch", "4"),), init,
                      eval=_lenet_batches(1, seed=7)[0][0]),
        "dropout_gpipe": dict(
            net=DROPOUT_NET, batch=16, steps=3, shape=(1, 1, 144),
            extra=EXTRA + (("mesh", "data:2,pipe:2"),
                           ("pipe_microbatch", "4"),
                           ("pipe_schedule", "gpipe"))),
        "dropout_1f1b": dict(
            net=DROPOUT_NET, batch=16, steps=3, shape=(1, 1, 144),
            extra=EXTRA + (("mesh", "data:2,pipe:2"),
                           ("pipe_microbatch", "4"),
                           ("pipe_schedule", "1f1b"))),
        "ckpt": _case(LENET, lambda: _lenet_batches(2), "data:2,pipe:2",
                      (("pipe_microbatch", "4"),
                       ("pipe_schedule", "1f1b")), init,
                      ckpt=str(out / "pipe.ckpt")),
    }
    port = ranks.run_group(cases + list(more.values()), out, 4)
    res = {cid: (jax_res[cid], port[i])
           for i, (cid, *_) in enumerate(CASES)}
    res["ckpt_path"] = more["ckpt"]["ckpt"]
    for j, name in enumerate(more):
        res[name] = (None, port[len(CASES) + j])
        if more[name].get("all_ranks"):
            res[name + "_ranks"] = ranks.rank_results(
                str(out), len(CASES) + j, 4)
    return res


def _assert_params_close(port_params, jax_params, what):
    from cxxnet_tpu_torch.nnet.trainer import flat_tags
    assert sorted(port_params) == sorted(jax_params)
    for pkey, g in port_params.items():
        jg = flat_tags(jax_params[pkey])
        assert sorted(g) == sorted(jg), pkey
        for tag, v in g.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jg[tag], np.float32), rtol=0,
                atol=PARAM_ATOL, err_msg=f"{what}: {pkey}/{tag}")


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_pipelined_trainer_matches_jax(runs, cid):
    """Losses within 1e-6 relative and parameters within 1e-5 of the JAX
    package's pipelined run on its mesh; replicas bitwise."""
    (_, jlosses, jparams), port = runs[cid]
    assert len(port["losses"]) == len(jlosses) == 3
    np.testing.assert_allclose(port["losses"], jlosses, rtol=LOSS_RTOL,
                               atol=0, err_msg=cid)
    _assert_params_close(port["state"]["params"], jparams, cid)
    assert port["drift"] == [0.0] * 3, port["drift"]


def test_1f1b_first_loss_equals_gpipe_bitwise(runs):
    """One reduction under both schedules: the first step's loss is
    bitwise equal, later steps within 1e-6 (the float32 gradient sums
    run in another microbatch order)."""
    for a, b in (("pipe4_gpipe", "pipe4_1f1b"),
                 ("dp_pipe_gpipe", "dp_pipe_1f1b")):
        la, lb = runs[a][1]["losses"], runs[b][1]["losses"]
        assert la[0] == lb[0], (a, la, lb)
        np.testing.assert_allclose(la[1:], lb[1:], rtol=1e-6, atol=0)


def test_schedules_draw_the_same_masks(runs):
    """Masks are drawn once per (microbatch, stage), on the stage's
    forward, in microbatch order under both schedules: a dropout net's
    first loss is bitwise GPipe's under 1F1B (same weights, same masks),
    and the later ones within 1e-6."""
    g, f = runs["dropout_gpipe"][1], runs["dropout_1f1b"][1]
    assert g["losses"][0] == f["losses"][0], (g["losses"], f["losses"])
    np.testing.assert_allclose(f["losses"][1:], g["losses"][1:], rtol=1e-6,
                               atol=0)
    assert g["drift"] == f["drift"] == [0.0] * 3


def test_bucketed_1f1b_reduction_bitwise_whole_tree(runs):
    """dp_overlap = 1 under 1F1B at a float32 wire: each bucket reduced
    at its stage's cooldown tick equals the one whole-tree reduction
    after the schedule, losses and parameters bitwise."""
    bucketed = runs["dp_pipe_1f1b_overlap"][1]
    whole = runs["whole_tree"][1]
    assert bucketed["losses"] == whole["losses"]
    for pkey, g in whole["state"]["params"].items():
        for tag, v in g.items():
            assert torch.equal(bucketed["state"]["params"][pkey][tag], v), \
                (pkey, tag)


def test_1f1b_in_flight_bound_flat_in_n_micro(runs):
    """Stage s holds at most 2(S-1-s)+1 microbatch graphs at 8 and at 16
    microbatches (the JAX package's ring lengths); GPipe holds all 16."""
    for name in ("live8", "live16"):
        for r, res in enumerate(runs[name + "_ranks"]):
            bound = 2 * (4 - 1 - r) + 1
            n_micro = 8 if name == "live8" else 16
            live = {st["live_max"] for st in res["pipe_stats"]}
            assert live == {min(bound, n_micro)}, (name, r, live)
    for res in runs["live16_gpipe_ranks"]:
        assert {st["live_max"] for st in res["pipe_stats"]} == {16}


def test_pipelined_eval_matches_one_device(runs):
    """The eval forward on pipe:4 (through the stages, the final node
    from the last one, on every rank) gives the one-device values of the
    same weights; the predicted classes agree."""
    got = runs["eval"][1]["eval"].numpy()
    init = runs["dp_pipe_1f1b_overlap"][0][0]
    from cxxnet_tpu_torch.nnet.trainer import params_from_jax
    t = ranks.port_trainer(LENET, 16, "cpu", EXTRA)
    t.set_state(*params_from_jax(*init))
    x = torch.from_numpy(_lenet_batches(1, seed=7)[0][0])
    (want,) = t.forward_eval(x, [t.net.final_node])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_pipe_ckpt_loads_in_jax_bitwise(runs):
    """A data:2,pipe:2 run's ``.ckpt`` is the one-device format: the JAX
    package's trainer loads it on its own pipe mesh and holds the port's
    parameters bitwise."""
    from cxxnet_tpu_torch.nnet.trainer import flat_tags
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    res = runs["ckpt"][1]
    jt = JTrainer()
    for k, v in (("batch_size", "16"), ("dev", "cpu:0-3"),
                 ("mesh", "data:2,pipe:2"), ("pipe_microbatch", "4"),
                 ("silent", "1")):
        jt.set_param(k, v)
    jt.load_model(runs["ckpt_path"])
    for pkey, g in res["state"]["params"].items():
        jg = flat_tags(jax.tree.map(np.asarray, jt.params[pkey]))
        for tag, v in g.items():
            np.testing.assert_array_equal(jg[tag], v.numpy(),
                                          err_msg=f"{pkey}/{tag}")


# ------------------------------------------------------------ toy stages

@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    return ranks.run_toys(tmp_path_factory.mktemp("toys"))


def _jax_toys():
    """The JAX package's functions on the toy inputs, on a pipe:2 mesh
    of host devices."""
    from jax.sharding import Mesh
    from cxxnet_tpu.parallel import pipeline as jp
    inp = {k: jnp.asarray(v) for k, v in ranks.toy_inputs().items()}
    mesh = Mesh(np.array(jax.devices("cpu")[:ranks.TOY_S]), ("pipe",))
    stacked = {"w": inp["w"], "b": inp["b"]}

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    out = {"apply": jp.pipeline_apply(stage_fn, stacked, inp["x"],
                                      mesh=mesh)}
    out["1f1b"] = jp.pipeline_1f1b(
        stage_fn, lambda y, lab: ((y - lab) ** 2).sum(), stacked, inp["x"],
        inp["lab"], mesh=mesh)
    out["train_step"] = jp.pipeline_train_step(
        stage_fn, lambda y, lab: ((y - lab) ** 2).mean(), stacked,
        inp["x"], inp["lab"], mesh=mesh, lr=0.1)
    hp = {"w0": inp["w0"], "w1": inp["w1"]}

    def st0(p, value, m):
        acts, aux, extra = value
        x = acts[0] if isinstance(acts, tuple) else acts
        h = jnp.tanh(x @ p["w0"])
        return (h,), aux + 0.01 * (h ** 2).sum(), extra

    def st1(p, value, m):
        acts, aux, extra = value
        return (acts[0] @ p["w1"],), aux, extra

    out["hetero"] = jp.pipeline_apply_hetero([st0, st1], hp, inp["x"],
                                             mesh=mesh)
    loss, grads, _, _ = jp.pipeline_1f1b_hetero(
        [st0, st1], lambda p, b, e, m: b[1] + (b[0][0] ** 2).sum(), hp,
        inp["x"], mesh=mesh)
    out["1f1b_hetero"] = (loss, grads)
    return jax.tree.map(np.asarray, out)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOY_TOL * scale, (
        what, float(np.abs(got - want).max()), scale)


def test_toy_stages_match_jax(toys):
    """Every entry point of parallel/pipeline.py on the toy stages
    against the JAX package's function: outputs, per-microbatch aux
    totals, losses, and each stage's gradients (its slice of the JAX
    package's stacked ones), on both ranks."""
    want = _jax_toys()
    for s, got in enumerate(toys):
        _close(got["apply"], want["apply"], "apply")
        for sched in ("1f1b", "gpipe"):
            loss, grads = got[f"1f1b_{sched}"]
            _close(loss, want["1f1b"][0], f"{sched} loss")
            for k in ("w", "b"):
                _close(grads[k], want["1f1b"][1][k][s], f"{sched} d{k}")
        new, loss = got["train_step"]
        jnew, jloss = want["train_step"]
        _close(loss, jloss, "train_step loss")
        for k in ("w", "b"):
            _close(new[k], jnew[k][s], f"train_step {k}")
        outs, auxs = got["hetero"]
        (jouts,), jauxs = want["hetero"]
        _close(outs, jouts, "hetero outs")
        _close(auxs, jauxs, "hetero aux")
        loss, grads = got["1f1b_hetero"]
        _close(loss, want["1f1b_hetero"][0], "1f1b_hetero loss")
        for k, g in zip(("w0", "w1"), grads):
            _close(g, want["1f1b_hetero"][1][k], f"1f1b_hetero d{k}")


# ------------------------------------------------------- pipeline_lm.conf

PIPE_CONF = os.path.join(REPO, "example", "LM", "pipeline_lm.conf")


def test_pipeline_lm_conf_matches_jax_cli(tmp_path):
    """example/LM/pipeline_lm.conf as shipped through the JAX package's
    CLI (cpu:0-7) and the port's (8 gloo ranks), from one initial
    snapshot over the same corpus (3 steps), only ``path_tok`` given on
    the command line: losses within 1e-6 relative, parameters within
    1e-5, replicas bitwise (``test_on_server = 1``); each step and round
    record carries ``pipe_bubble_frac`` = (S-1)/(M+S-1) = 1/9 and the
    port's ledger carves that share of dispatch as ``pipe_bubble``."""
    from test_torch_ring import write_init_model, write_lm_corpus
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils import serializer
    corpus = write_lm_corpus(tmp_path, 16, 128)
    init = str(tmp_path / "init.model")
    write_init_model(PIPE_CONF, init)
    out = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        d = str(tmp_path / name)
        sink = d + ".jsonl"
        argv = [PIPE_CONF, f"path_tok={corpus}", f"model_in={init}",
                f"model_dir={d}", "max_round=1", "save_model=1",
                "print_step=1", "test_on_server=1", "silent=1",
                f"metrics_sink=jsonl:{sink}"]
        # the JAX CLI sets the conf's engine options process-wide
        # (dp_overlap, fullc_gather): put them back for later tests
        saved = engine.snapshot()
        try:
            assert task().run(argv) == 0, name
        finally:
            for k, v in saved.items():
                engine.opts.set(k, v)
        recs = [json.loads(x) for x in open(sink)]
        last = sorted(f for f in os.listdir(d) if f.endswith(".model"))[-1]
        _, params, _, _ = serializer.load_model(os.path.join(d, last))
        out[name] = (recs, params)
    (jrecs, jp), (trecs, tp) = out["jax"], out["port"]
    jl = [r["loss"] for r in jrecs if r["kind"] == "step"]
    tl = [r["loss"] for r in trecs if r["kind"] == "step"]
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    for key, group in jp.items():
        for tag, v in group.items():
            np.testing.assert_allclose(tp[key][tag], v, rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{key}/{tag}")
    frac = 1.0 / 9.0
    for recs in (jrecs, trecs):
        stamped = [r for r in recs if r["kind"] in ("step", "round")]
        assert stamped and all(r["pipe_bubble_frac"] == pytest.approx(
            frac, abs=1e-4) for r in stamped)
    led = [r for r in trecs if r["kind"] == "ledger"][-1]
    disp = sum(r["dispatch_sec"] for r in trecs if r["kind"] == "round")
    assert led["categories"]["pipe_bubble"] == pytest.approx(
        disp * round(frac, 4), rel=1e-3, abs=1e-6)


# ----------------------------------------------------- gates on meta

def _meta_trainer(extra):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(LENET):
        t.set_param(k, v)
    for k, v in (("batch_size", "16"), ("dev", "cpu")) + EXTRA \
            + tuple(extra):
        t.set_param(k, v)
    t.init_model(torch.device("meta"))
    return t


@pytest.mark.parametrize("mesh,n_micro", [("data:2,pipe:2", 4),
                                          ("pipe:4", 4), ("pipe:2", 8),
                                          ("data:4", 0)])
def test_pipe_bubble_frac_matches_jax(mesh, n_micro):
    """The stamped share is the JAX trainer's analytic (S-1)/(M+S-1),
    0.0 without a pipe axis."""
    extra = [("mesh", mesh), ("pipe_microbatch", str(n_micro))]
    jt = _make_trainer(LENET, 16, "cpu:0-3" if "pipe:2" != mesh
                       else "cpu:0-1", extra=list(EXTRA) + extra)
    t = _meta_trainer(extra)
    assert t.pipe_bubble_frac == pytest.approx(jt.pipe_bubble_frac,
                                               rel=0, abs=1e-12)


def test_remat_with_pipe_refused_in_jax_words():
    """remat and a pipe axis are mutually exclusive, refused at the first
    step in the JAX package's words."""
    from cxxnet_tpu_torch.layers.base import LabelInfo
    t = _meta_trainer([("mesh", "data:2,pipe:2"), ("pipe_microbatch", "2"),
                       ("pipe_schedule", "1f1b"), ("remat", "2")])
    x = torch.empty((16, 1, 28, 28), device="meta")
    with pytest.raises(AssertionError, match="remat and mesh=pipe are "
                       "mutually exclusive"):
        t._loss_grads_outs({0: x}, LabelInfo(fields={}))


def test_gpipe_dp_overlap_warns_in_jax_words(capsys):
    """GPipe under dp_overlap = 1 keeps the whole-tree reduction with
    one warning, the JAX package's; 1F1B composes (a bucket plan over
    both stages, no warning)."""
    t = _meta_trainer([("mesh", "data:2,pipe:2"), ("dp_overlap", "1"),
                       ("pipe_schedule", "gpipe")])
    capsys.readouterr()
    assert not t._dp_overlap_active() and not t._dp_overlap_active()
    err = capsys.readouterr().err
    words = ("dp_overlap = 1 ignored: the gpipe pipeline schedule's "
             "backward is autodiff-scheduled (pipe_schedule = 1f1b "
             "composes); using the implicit-psum step")
    assert err.count(words) == 1, err
    assert t._pipe_bucket_plan() is None
    t = _meta_trainer([("mesh", "data:2,pipe:2"), ("dp_overlap", "1"),
                       ("pipe_schedule", "1f1b"), ("dp_bucket_mb", "0.01")])
    capsys.readouterr()
    assert not t._dp_overlap_active()
    plan = t._pipe_bucket_plan()
    assert sorted({st for _, st in plan}) == [0, 1]
    assert sorted(k for ks, _ in plan for k in ks) == sorted(t.params)
    assert "ignored" not in capsys.readouterr().err

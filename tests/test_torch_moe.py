"""The port's ``moe`` layer and expert parallelism against the JAX
package, on the CPU.

* One device, layer level (weights from the JAX package's init): both
  dispatch paths at capacity factors with and without drops, the
  outputs, the aux loss and every gradient (the parameters' and the
  input's) against the JAX layer's, with and without a tail-batch loss
  mask; sorted against dense in the port; a dropped token is its
  residual exactly; ``router_jitter`` with the same draws injected into
  both packages.  Bounds: outputs and the aux loss within 1e-6 of the
  largest value, gradients within 1e-5 normwise.
* ``example/LM/moe_lm.conf`` at ``mesh = data:2,expert:2`` and its net
  at ``data:2,model:2`` and ``data:2,seq:2`` through the port's CLI (four gloo ranks)
  against the JAX package's CLI on ``cpu:0-3``, from one JAX-written
  initial snapshot over the same corpus (3 batches): per-step losses
  within 1e-6 relative, parameters within 1e-5, replicas bitwise equal
  (``test_on_server = 1``).
* The same data:2,expert:2 run through the trainer on four spawned
  ranks: each rank holds only its two experts of every per-expert
  tensor and their adam state; its ``.ckpt`` holds the logical arrays,
  which the JAX package's trainer loads on its own mesh bitwise.
* every mesh axis is taken (``pipe`` too); the
  ``dp_overlap = 1`` fallbacks of the seq / expert axes and of a moe
  layer on a model axis warn once, in the JAX package's words.
"""

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
from cxxnet_tpu.layers.base import ForwardContext as JCtx  # noqa: E402
from cxxnet_tpu.layers.base import LabelInfo as JLabels  # noqa: E402
from cxxnet_tpu.layers.registry import create_layer as jcreate  # noqa: E402
from test_torch_ring import (assert_cli_parity, cli_runs,  # noqa: E402
                             write_init_model, write_lm_corpus)

#: outputs / aux loss (of the largest value) and gradients (normwise)
OUT_TOL = 1e-6
GRAD_TOL = 1e-5
MOE_CONF = os.path.join(REPO, "example", "LM", "moe_lm.conf")


def _layers(cfg):
    from cxxnet_tpu_torch.layers.registry import create_layer
    jl, tl = jcreate("moe"), create_layer("moe")
    for k, v in cfg.items():
        jl.set_param(k, str(v))
        tl.set_param(k, str(v))
    return jl, tl


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _both(cfg, shape=(2, 1, 16, 12), seed=2, mask=None, train=True):
    """The JAX layer and the port's on the same input and weights: their
    (output, aux loss or None, {name: gradient}) of ``sum(out ** 2) +
    aux``, the input's gradient under ``x``."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.base import ForwardContext, LabelInfo
    jl, tl = _layers(cfg)
    jl.infer_shapes([shape])
    tl.infer_shapes([shape])
    params = jl.init_params(jax.random.PRNGKey(5), [shape])
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    b = shape[0]

    def jloss(p, xx):
        ctx = JCtx(train=train, loss_scale=1.0 / b,
                   rng=jax.random.PRNGKey(0),
                   labels=None if mask is None else JLabels(
                       fields={}, mask=jnp.asarray(mask)))
        (out,), _ = jl.forward(p, {}, [xx], ctx)
        aux = ctx.losses[0] if ctx.losses else jnp.float32(0)
        return (out ** 2).sum() + aux, (out, aux)
    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ctx = ForwardContext(train=train, opts=EngineOptions(),
                         loss_scale=1.0 / b,
                         rng=torch.Generator().manual_seed(0),
                         labels=None if mask is None else LabelInfo(
                             fields={}, mask=torch.from_numpy(mask)))
    (tout,) = tl.forward(tp, [tx], ctx)
    taux = ctx.losses[0] if ctx.losses else torch.zeros(())
    ((tout ** 2).sum() + taux).backward()
    jgrads = {**{k: np.asarray(v) for k, v in jg.items()},
              "x": np.asarray(jgx)}
    tgrads = {**{k: v.grad.numpy() for k, v in tp.items()},
              "x": tx.grad.numpy()}
    return ((np.asarray(jout), float(jaux), jgrads),
            (tout.detach().numpy(), float(taux.detach()), tgrads))


def _assert_same(j, t, what):
    jout, jaux, jg = j
    tout, taux, tg = t
    scale = float(np.abs(jout).max())
    assert float(np.abs(tout - jout).max()) <= OUT_TOL * scale, what
    assert abs(taux - jaux) <= OUT_TOL * max(abs(jaux), 1e-30), (what, taux,
                                                                 jaux)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert _normwise(tg[k], jg[k]) <= GRAD_TOL, (what, k,
                                                     _normwise(tg[k], jg[k]))


BASE = {"num_expert": 4, "nhidden": 16, "init_sigma": 0.2}


@pytest.mark.parametrize("cf", [10.0, 0.6, 0.5])
@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
def test_moe_matches_jax_layer(cf, dispatch):
    """Output, aux loss and every gradient against the JAX layer, both
    dispatch paths; at cf 0.6 and 0.5 tokens are dropped at capacity."""
    j, t = _both({**BASE, "capacity_factor": cf, "moe_dispatch": dispatch})
    _assert_same(j, t, (cf, dispatch))


def test_moe_tail_mask_aux_loss_matches_jax():
    """With a tail-batch loss mask, the aux loss's fractions and mean
    probabilities count the unmasked rows only, as the JAX layer's."""
    mask = np.array([1, 1, 0], np.float32)
    j, t = _both({**BASE, "capacity_factor": 1.0}, shape=(3, 1, 8, 12),
                 mask=mask)
    _assert_same(j, t, "mask")


def test_moe_eval_forward_has_no_aux_loss():
    (jout, jaux, _), (tout, taux, _) = _both(
        {**BASE, "capacity_factor": 0.6}, train=False)
    assert jaux == taux == 0.0
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=OUT_TOL * np.abs(jout).max())


def test_moe_sorted_matches_dense_in_the_port():
    """The port's sorted dispatch reproduces its dense one-hot path at a
    tight capacity: outputs and every gradient."""
    _, dense = _both({**BASE, "capacity_factor": 0.6,
                      "moe_dispatch": "dense"})
    _, srt = _both({**BASE, "capacity_factor": 0.6,
                    "moe_dispatch": "sorted"})
    _assert_same(dense, srt, "sorted vs dense")


def test_moe_capacity_boundary_continuity():
    """Capacity 1 (cf 0.01): at most one token an expert differs from
    its input; every dropped token's output is its input exactly."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.base import ForwardContext
    _, tl = _layers({"num_expert": 2, "nhidden": 8,
                     "capacity_factor": 0.01, "init_sigma": 0.2})
    shape = (1, 1, 8, 6)
    tl.infer_shapes([shape])
    params = tl.init_params(torch.Generator().manual_seed(3), [shape])
    x = torch.from_numpy(np.random.RandomState(4).randn(*shape)
                         .astype(np.float32))
    (out,) = tl.forward(params, [x], ForwardContext(
        train=False, opts=EngineOptions()))
    diff = (out - x).abs().reshape(8, 6).amax(dim=1)
    assert int((diff > 0).sum()) <= 2


def test_router_jitter_with_injected_draws(monkeypatch):
    """``router_jitter = 0.3`` in a training forward with the same
    uniform draws injected into both packages (their generators
    differ): output, aux loss and gradients as the JAX layer's."""
    from cxxnet_tpu_torch.ops import nn as TN
    shape = (2, 1, 16, 12)
    u = np.random.RandomState(9).rand(2 * 16, 12).astype(np.float32)
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, s, dtype=jnp.float32, minval=0.0, maxval=1.0:
        (jnp.float32(minval) + jnp.float32(maxval - minval)
         * jnp.asarray(u).reshape(s)).astype(dtype))
    monkeypatch.setattr(TN, "uniform", lambda gen, s, dtype:
                        torch.from_numpy(u).reshape(s).to(dtype))
    j, t = _both({**BASE, "capacity_factor": 0.6, "router_jitter": 0.3},
                 shape=shape)
    _assert_same(j, t, "jitter")
    j0, _ = _both({**BASE, "capacity_factor": 0.6}, shape=shape)
    assert float(np.abs(j[0] - j0[0]).max()) > 0  # the draws did change it


# ----------------------------------------------------- whole confs, CLI

@pytest.fixture(scope="module")
def moe_corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    corpus = write_lm_corpus(tmp, 8, 128)
    init = str(tmp / "init.model")
    return tmp, corpus, init, write_init_model(MOE_CONF, init)


@pytest.mark.parametrize("mesh", ["data:2,expert:2", "data:2,model:2",
                                  "data:2,seq:2"])
def test_moe_lm_mesh_matches_jax_cli(moe_corpus, mesh):
    """example/LM/moe_lm.conf as shipped (4 experts of 256, capacity
    factor 2, adam) on its data:2,expert:2 mesh, on data:2,model:2 (the
    model axis hosts the experts) and on data:2,seq:2 (each rank a block
    of every row's positions: a token's slot counts the blocks before
    it): the port's CLI against the JAX package's, 3 steps from one
    initial snapshot."""
    tmp, corpus, init, _ = moe_corpus
    assert_cli_parity(cli_runs(MOE_CONF, tmp, mesh, corpus, init,
                               mesh.replace(":", "").replace(",", "_")))


def _lm_batches(corpus, n):
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    it = init_iterator(create_iterator(
        [("iter", "text"), ("path_tok", corpus), ("tok_count", "4"),
         ("iter", "packseq"), ("seqlen", "128"), ("iter", "end")]),
        [("batch_size", "8"), ("silent", "1")])
    it.before_first()
    return [(b.data, b.label, 0) for b in (it.next() for _ in range(n))]


def test_experts_live_on_their_rank_and_the_ckpt_crosses(moe_corpus):
    """Four spawned ranks of data:2,expert:2 train moe_lm.conf's net 3
    steps: rank 0 holds experts 0-1 of every per-expert tensor
    (``wmat``, ``wmat2``, ``bias``, ``bias2``) and of its adam state,
    the gate whole; replicas agree bitwise after every step; the
    ``.ckpt`` it writes holds the logical arrays (the gathered experts),
    and the JAX package's trainer loads it onto its own data:2,expert:2
    mesh and holds them bitwise."""
    from test_torch_ring import conf_net
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    tmp, corpus, _, init = moe_corpus
    net = "\n".join(f"{k} = {v}" for k, v in conf_net(MOE_CONF))
    ck = str(tmp / "moe.ckpt")
    case = dict(net=net, batch=8, init=init, data=_lm_batches(corpus, 3),
                extra=(("mesh", "data:2,expert:2"), ("silent", "1")),
                ckpt=ck)
    (res,) = ranks.run_group([case], tmp, 4)
    assert res["drift"] == [0.0] * 3
    tags = ("wmat", "wmat2", "bias", "bias2")
    want = {f"{k}/{t}" for k in ("06-l0_moe", "12-l1_moe") for t in tags}
    assert set(res["expert"]) == want
    for name, (axis, rows, shape, opt) in res["expert"].items():
        assert axis == "expert" and rows == 4 and shape[0] == 2, name
        assert opt and all(s == shape for s in opt.values()), (name, opt)
    state = res["state"]
    assert state["params"]["06-l0_moe"]["wmat"].shape[0] == 4
    jt = JTrainer()
    for k, v in (("batch_size", "8"), ("dev", "cpu:0-3"),
                 ("mesh", "data:2,expert:2"), ("silent", "1")):
        jt.set_param(k, v)
    jt.load_model(ck)
    for pkey, g in state["params"].items():
        for tag, v in g.items():
            np.testing.assert_array_equal(
                np.asarray(jt.params[pkey][tag]), v.numpy(),
                err_msg=f"{pkey}/{tag}")
    for pkey, g in state["opt"].items():
        for tag, st in g.items():
            for name, v in st.items():
                np.testing.assert_array_equal(
                    np.asarray(jt.opt_state[pkey][tag][name]), v.numpy(),
                    err_msg=f"{pkey}/{tag}/{name}")


# ------------------------------------------------------- refusals, gates

def test_pipe_is_the_one_refused_axis():
    """``seq``, ``expert`` and ``pipe`` meshes and the moe layer are
    taken: no mesh axis is refused any more (the pipe axis came with the
    pipeline slice), and every axis with semantics is a ported one."""
    from cxxnet_tpu_torch.layers.registry import NOT_PORTED, create_layer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel.mesh import KNOWN_AXES, PORTED_AXES
    assert NOT_PORTED == () and create_layer("moe").type_names == ("moe",)
    assert set(PORTED_AXES) == set(KNOWN_AXES) == {
        "data", "model", "seq", "expert", "pipe"}
    for mesh in ("data:2,seq:2", "data:2,expert:2", "expert:4",
                 "data:2,pipe:2", "data:2,pipe:2,model:2"):
        t = NetTrainer()
        t.set_param("mesh", mesh)
        assert t.mesh_spec.size == np.prod(
            [int(a.split(":")[1]) for a in mesh.split(",")])


MOE_NET = """
netconfig=start
layer[0->1] = embedding
  vocab_size = 16
  nhidden = 8
layer[1->2] = moe
  num_expert = 4
  nhidden = 8
layer[2->3] = seq_fullc
  nhidden = 16
layer[3->3] = softmax_seq
netconfig=end
input_shape = 1,1,8
label_vec[0,8) = label
"""

GATES = [
    ("seq", "data:2,seq:2",
     "mesh axes seq need GSPMD-placed collectives (ring attention / "
     "expert all-to-all)"),
    ("expert", "data:2,expert:2",
     "mesh axes expert need GSPMD-placed collectives (ring attention / "
     "expert all-to-all)"),
    ("moe_model", "data:2,model:2",
     "the model axis hosts MoE experts; dispatch/combine all-to-alls are "
     "GSPMD-placed"),
]


@pytest.mark.parametrize("gid,mesh,words", GATES, ids=[g[0] for g in GATES])
def test_dp_overlap_fallback_warns_once(capsys, gid, mesh, words):
    """dp_overlap = 1 on a seq or expert mesh, or with a moe layer on a
    model axis, keeps the implicit step and warns once in the JAX
    package's words (on the trainer ``task = check`` builds)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(MOE_NET):
        t.set_param(k, v)
    for k, v in (("batch_size", "4"), ("dev", "cpu"), ("mesh", mesh),
                 ("dp_overlap", "1")):
        t.set_param(k, v)
    t.init_model(torch.device("meta"))
    capsys.readouterr()
    assert not t._dp_overlap_active()
    assert not t._dp_overlap_active()
    err = capsys.readouterr().err
    line = f"dp_overlap = 1 ignored: {words}; using the implicit-psum step"
    assert err.count(line) == 1, err

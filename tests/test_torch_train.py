"""The port's training slice against the JAX package, on the CPU.

Kernel modules: the plain versions of the flash-attention backward, the
segmented flash forward / backward and the layernorm backward against
the JAX package's Pallas kernels in interpret mode (as
tests/test_pallas.py and tests/test_text.py run them), and each new
autograd Function's CPU path under ``torch.autograd.gradcheck``.
Training: the updaters against the JAX ``Updater.apply``, the fused
adam update's plain version against the Pallas ``fused_adam_pallas``
(interpret mode) and its gate against the JAX gate, the tiny packed
transformer LM stepped by both trainers from the same weights and
batches (in bf16 under ``fused_update = 1`` too), both CLIs training
from one snapshot, and the train keys the port refuses.  Inputs come
from numpy with a seed.  The CUDA kernels
themselves are held to these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
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

from cxxnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from cxxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402

# the training envelope of the port (ROADMAP.md): grads per tensor,
# max |got - ref| / max |ref|
GRAD_TOL = 5e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- flash

@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_pallas_vjp(causal, monkeypatch):
    """flash_attention_bwd_plain (from the port's own forward) == jax.vjp
    of the Pallas flash attention in interpret mode, f32 b1 h2 s1024 d32
    with (256, 256) blocks, so the dq and dk/dv passes cross several
    blocks per row and column: dq / dk / dv within 2e-4."""
    monkeypatch.setattr(pk, "_fa_blocks", lambda s, d=64: (256, 256))
    rnd = np.random.RandomState(11)
    b, h, s, d = 1, 2, 1024, 32
    q, k, v, do = (rnd.randn(b, h, s, d).astype(np.float32) * 0.5
                   for _ in range(4))
    _, vjp = jax.vjp(lambda *a: pk.flash_attention(*a, causal, None, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    q3, k3, v3, do3 = (_t(a.reshape(b * h, s, d)) for a in (q, k, v, do))
    o3, lse3 = fa.flash_attention_fwd_plain(q3, k3, v3, causal)
    got = fa.flash_attention_bwd_plain(q3, k3, v3, o3, lse3, do3, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy().reshape(b, h, s, d),
                                   np.asarray(w), atol=2e-4, err_msg=name)


def _seg_inputs(seed, layout, d=16):
    rnd = np.random.RandomState(seed)
    b, h, s = 2, 2, 256
    q, k, v, do = (rnd.randn(b, h, s, d).astype(np.float32)
                   for _ in range(4))
    seg = np.zeros((b, s), np.int32)
    if layout == "boundaries":
        # document boundaries inside the 256-row block, padding tail
        for row, cuts in enumerate(((37, 100, 190), (5, 130))):
            edges = (0,) + cuts + (s - 24 * row,)
            for i in range(len(edges) - 1):
                seg[row, edges[i]:edges[i + 1]] = i + 1
    else:
        # padding inside rows too: segment 0 attends only its diagonal
        seg[0, :60] = 1
        seg[0, 60:70] = 0
        seg[0, 70:] = 2
        seg[1, :] = 0
        seg[1, 100:200] = 3
    return q, k, v, do, seg


@pytest.mark.parametrize("layout,d", [
    pytest.param("boundaries", 16, id="boundaries"),
    pytest.param("padding", 16, id="padding"),
    pytest.param("boundaries", 256, id="boundaries-d256")])
def test_flash_seg_fwd_plain_matches_pallas(layout, d):
    """flash_attention_seg_fwd_plain == the segmented Pallas forward
    (interpret mode), at head width 16 and at 256 (the widest the
    segmented kernels take): o and lse within 1e-5."""
    q, k, v, _, seg = _seg_inputs(12, layout, d)
    b, h, s, d = q.shape
    o_j, res = pk._flash_seg_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(seg),
                                     None, True)
    o_t, lse_t = fa.flash_attention_seg_fwd_plain(
        *(_t(a.reshape(b * h, s, d)) for a in (q, k, v)), _t(seg))
    np.testing.assert_allclose(o_t.numpy().reshape(b, h, s, d),
                               np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(res[5]), atol=1e-5)


@pytest.mark.parametrize("layout", ["boundaries", "padding"])
def test_flash_seg_bwd_plain_matches_pallas_vjp(layout):
    """flash_attention_seg_bwd_plain == jax.vjp of the segmented Pallas
    flash attention (interpret mode): grads within 2e-4."""
    q, k, v, do, seg = _seg_inputs(13, layout)
    b, h, s, d = q.shape
    _, vjp = jax.vjp(lambda *a: pk.flash_attention_segmented(
        *a, jnp.asarray(seg), interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    q3, k3, v3, do3 = (_t(a.reshape(b * h, s, d)) for a in (q, k, v, do))
    o3, lse3 = fa.flash_attention_seg_fwd_plain(q3, k3, v3, _t(seg))
    got = fa.flash_attention_seg_bwd_plain(q3, k3, v3, _t(seg), o3, lse3,
                                           do3)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy().reshape(b, h, s, d),
                                   np.asarray(w), atol=2e-4, err_msg=name)


def test_flash_wrappers_use_plain_versions_on_cpu():
    """A CPU tensor takes the plain versions and launches no kernel."""
    rnd = np.random.RandomState(14)
    q, k, v, do = (_t(rnd.randn(4, 40, 24).astype(np.float32))
                   for _ in range(4))
    seg = _t(np.repeat([[1] * 30 + [2] * 10], 2, axis=0))
    counters = [fa.flash_attention_bwd, fa.flash_attention_seg_fwd,
                fa.flash_attention_seg_bwd]
    before = [f.launches for f in counters]
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    o2, lse2 = fa.flash_attention_seg_fwd(q, k, v, seg)
    assert torch.equal(o2, fa.flash_attention_seg_fwd_plain(q, k, v, seg)[0])
    fa.flash_attention_seg_bwd(q, k, v, seg, o2, lse2, do)
    assert [f.launches for f in counters] == before


# ------------------------------------------------------------ layernorm

@pytest.mark.parametrize("save_x,rows,d", [
    pytest.param(False, 256, 128, id="False"),
    pytest.param(True, 256, 128, id="True"),
    # wider than the port's backward took before its stream route: the
    # reference's kernel runs there (layernorm_pallas_supported)
    pytest.param(False, 8, 16384, id="False-d16384"),
    pytest.param(True, 8, 16384, id="True-d16384"),
])
def test_layernorm_bwd_plain_matches_pallas_vjp(save_x, rows, d):
    """layernorm_bwd_plain == jax.vjp of layernorm_pallas (interpret
    mode) for both residual contracts, with one gamma column exactly 0
    (xhat = 0 there under the default rebuild): dx, dg, db within 1e-5."""
    assert pk.layernorm_pallas_supported(rows, d) or pk.pltpu is None
    rnd = np.random.RandomState(15)
    x = rnd.randn(rows, d).astype(np.float32)
    g = (rnd.rand(d) + 0.5).astype(np.float32)
    g[7] = 0.0
    b = (rnd.randn(d) * 0.5).astype(np.float32)
    dy = rnd.randn(rows, d).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pk.layernorm_pallas(*a, 1e-5, True, save_x),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    y, mean, rstd = ln.layernorm_fwd_plain(_t(x), _t(g), _t(b), 1e-5)
    a = _t(x) if save_x else y
    got = ln.layernorm_bwd_plain(_t(dy), a, _t(g), _t(b), mean, rstd,
                                 save_x)
    for gt, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_layernorm_function_residuals_and_cpu_path():
    """The Function saves (y, gamma, beta, rstd) by default — never x —
    and (x, gamma, beta, mean, rstd) with save_x; the CPU path launches
    no kernel."""
    rnd = np.random.RandomState(16)
    x = _t(rnd.randn(6, 16).astype(np.float32)).requires_grad_()
    g = _t((rnd.rand(16) + 0.5).astype(np.float32)).requires_grad_()
    b = _t(rnd.randn(16).astype(np.float32)).requires_grad_()
    before = (ln.layernorm_fwd.launches, ln.layernorm_bwd.launches)
    y = ln.layernorm(x, g, b, 1e-5)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[0].data_ptr() == y.data_ptr()
    assert all(t.data_ptr() != x.data_ptr() for t in saved)
    y.sum().backward()
    y2 = ln.layernorm(x, g, b, 1e-5, True)
    assert y2.grad_fn.saved_tensors[0].data_ptr() == x.data_ptr()
    assert (ln.layernorm_fwd.launches, ln.layernorm_bwd.launches) == before


# ------------------------------------------------------------- gradcheck

def _dbl(rnd, *shape):
    return torch.from_numpy(rnd.randn(*shape)).requires_grad_()


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_flash_attention(causal):
    rnd = np.random.RandomState(17)
    q, k, v = (_dbl(rnd, 2, 12, 8) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, causal), (q, k, v))


def test_gradcheck_flash_attention_segmented():
    rnd = np.random.RandomState(18)
    q, k, v = (_dbl(rnd, 4, 12, 8) for _ in range(3))
    seg = torch.tensor([[1] * 5 + [2] * 5 + [0] * 2, [0] * 3 + [1] * 9])
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention_segmented(q, k, v, seg),
        (q, k, v))


@pytest.mark.parametrize("save_x", [False, True])
def test_gradcheck_layernorm(save_x):
    rnd = np.random.RandomState(19)
    x = _dbl(rnd, 5, 8)
    g = torch.from_numpy(rnd.rand(8) + 0.5).requires_grad_()
    b = _dbl(rnd, 8)
    assert torch.autograd.gradcheck(
        lambda x, g, b: ln.layernorm(x, g, b, 1e-5, save_x), (x, g, b))


# -------------------------------------------------------------- updaters

_HYPER_KEYS = [("eta", "0.05"), ("wd", "0.01"), ("momentum", "0.8"),
               ("clip_gradient", "0.5"), ("lr:schedule", "expdecay"),
               ("lr:gamma", "0.5"), ("lr:step", "2"), ("wmat:lr", "0.1"),
               ("bias:wd", "0.0")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "nag", "adam"])
def test_updater_step_matches_jax(name, dtype):
    """Two chained steps (epochs 5, 6) of each updater == the JAX
    Updater.apply on the same p, g and state: an expdecay lr schedule,
    wd > 0, a NaN and an out-of-range value under the clip, and for
    bf16 the float32 master."""
    from cxxnet_tpu.updater import updaters as ju
    from cxxnet_tpu_torch.updater import updaters as tu
    rnd = np.random.RandomState(20)
    p0 = (rnd.randn(8, 16) * 0.3).astype(np.float32)
    jh, th = ju.UpdaterHyper(tag="wmat"), tu.UpdaterHyper(tag="wmat")
    for k, v in _HYPER_KEYS:
        jh.set_param(k, v)
        th.set_param(k, v)
    assert th == tu.UpdaterHyper(**vars(jh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jup, tup = ju.create_updater(name), tu.create_updater(name)
    jp = jnp.asarray(p0).astype(jdt)
    tp = _t(p0).to(tdt)
    js, ts = jup.make_state(jp), tup.make_state(tp)
    assert sorted(js) == sorted(ts)
    for epoch in (5, 6):
        g = (rnd.randn(8, 16) * 0.2).astype(np.float32)
        g[0, 0], g[1, 1] = np.nan, 7.0
        jp, js = jup.apply(jp, jnp.asarray(g).astype(jdt), js, jh, epoch)
        tup.apply(tp, _t(g).to(tdt), ts, th, epoch)
        np.testing.assert_allclose(tp.float().numpy(),
                                   np.asarray(jp, np.float32), rtol=1e-5,
                                   atol=1e-7, err_msg=f"p epoch {epoch}")
        for key in js:
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{key} epoch {epoch}")


def test_updater_hyper_schedules_match_jax():
    """lr / momentum of every schedule kind against the JAX hyper."""
    from cxxnet_tpu.updater import updaters as ju
    from cxxnet_tpu_torch.updater import updaters as tu
    for sched in ("constant", "expdecay", "polydecay", "factor"):
        keys = [("lr", "0.2"), ("lr:schedule", sched), ("lr:step", "3"),
                ("lr:start_epoch", "2"), ("momentum_schedule", "1"),
                ("saturation_epoch", "10"), ("lr:minimum_lr", "0.01")]
        jh, th = ju.UpdaterHyper(), tu.UpdaterHyper()
        for k, v in keys:
            jh.set_param(k, v)
            th.set_param(k, v)
        for e in (0, 1, 4, 9, 30):
            jl, jm = jh.schedule(e)
            tl, tm = th.schedule(e)
            np.testing.assert_allclose([tl, tm], [float(jl), float(jm)],
                                       rtol=1e-6, err_msg=f"{sched} {e}")


# ------------------------------------------------------ trainer and CLI

def _packed_net():
    from cxxnet_tpu_torch.models import transformer
    return transformer(vocab=64, seq=128, dim=64, nlayer=2, nhead=2,
                       packed=True)


def _write_corpus(path, seed=21, ndocs=60):
    from cxxnet_tpu_torch.io.text import write_token_shard
    rnd = np.random.RandomState(seed)
    write_token_shard(str(path), [rnd.randint(0, 64, rnd.randint(10, 90))
                                  for _ in range(ndocs)], itemsize=2)


def _batches(path, n):
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    it = init_iterator(create_iterator(
        [("iter", "text"), ("path_tok", str(path)), ("iter", "packseq"),
         ("seqlen", "128"), ("iter", "end")]),
        [("batch_size", "2"), ("silent", "1")])
    it.before_first()
    out = [it.next() for _ in range(n)]
    assert all(b is not None for b in out)
    return out


def _trainer_pair(updater, extra=()):
    """(JAX trainer, port trainer) on the tiny packed LM, same weights."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu_torch.models import transformer as tz
    from cxxnet_tpu.models import transformer as jz
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = _packed_net()
    assert net == jz(vocab=64, seq=128, dim=64, nlayer=2, nhead=2,
                     packed=True) == tz(vocab=64, seq=128, dim=64, nlayer=2,
                                        nhead=2, packed=True)
    keys = [("updater", updater), ("eta", "0.01"), ("eval_train", "0"),
            ("silent", "1")] + list(extra)
    jt = _make_trainer(net, 2, "cpu", extra=keys)
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in [("batch_size", "2"), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("updater", ["adam", "sgd"])
def test_trainer_losses_match_jax(updater, tmp_path):
    """Three steps of the tiny packed transformer (vocab 64, s128, d64,
    2 layers, 2 heads, f32, batch 2) in both trainers from the same
    weights and packseq batches: per-step losses within rel 1e-5; under
    sgd the params after 3 steps within 1e-5."""
    _write_corpus(tmp_path / "c.tok")
    batches = _batches(tmp_path / "c.tok", 3)
    jt, tt = _trainer_pair(updater)
    for step, batch in enumerate(batches):
        jt.update(batch)
        tt.update(batch)
        jl, tl = float(jt._last_loss), float(tt.last_loss)
        assert np.isfinite(tl)
        assert abs(tl - jl) <= 1e-5 * abs(jl), (step, tl, jl)
    assert tt.epoch_counter == jt.epoch_counter == 3
    if updater == "sgd":
        for key, group in jt.params.items():
            for tag, v in group.items():
                np.testing.assert_allclose(
                    tt.params[key][tag].numpy(), np.asarray(v), atol=1e-5,
                    err_msg=f"{key}/{tag}")


def test_trainer_step1_grads_match_jax(tmp_path):
    """Step-1 gradients per tensor within the 5e-3 grad envelope (max
    |diff| / max |grad|), the packed loss masking included."""
    _write_corpus(tmp_path / "c.tok")
    [batch] = _batches(tmp_path / "c.tok", 1)
    assert (batch.label[:, :128] < 0).any()  # boundary targets masked
    jt, tt = _trainer_pair("sgd")
    (jloss, _), jgrads = jt._loss_and_grads(
        jt.params, jt.buffers, jnp.asarray(batch.data),
        jnp.asarray(batch.label, jnp.float32), (), jnp.int32(0),
        jax.random.PRNGKey(0), ())
    tloss, tgrads = tt.loss_and_grads(batch)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(tgrads) == set(jgrads)
    for key, group in jgrads.items():
        for tag, g in group.items():
            err = _max_rel(tgrads[key][tag].numpy(), np.asarray(g))
            assert err <= GRAD_TOL, (key, tag, err)


def test_trainer_resumes_from_jax_optimizer_state(tmp_path):
    """One adam step in the JAX trainer; the port then starts from its
    params, adam moments and update counter (params_from_jax,
    opt_state_from_jax) and both take two more steps: losses within rel
    1e-5 and params within 1e-5."""
    from cxxnet_tpu_torch.nnet.trainer import (opt_state_from_jax,
                                               params_from_jax)
    _write_corpus(tmp_path / "c.tok")
    batches = _batches(tmp_path / "c.tok", 3)
    jt, tt = _trainer_pair("adam")
    jt.update(batches[0])
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    tt.set_opt_state(opt_state_from_jax(jax.tree.map(np.asarray,
                                                     jt.opt_state)))
    tt.epoch_counter = tt.sample_counter = jt.epoch_counter
    for batch in batches[1:]:
        jt.update(batch)
        tt.update(batch)
        jl = float(jt._last_loss)
        assert abs(float(tt.last_loss) - jl) <= 1e-5 * abs(jl)
    for key, group in jt.params.items():
        for tag, v in group.items():
            np.testing.assert_allclose(tt.params[key][tag].numpy(),
                                       np.asarray(v), atol=1e-5)


def test_trainer_update_period_matches_jax(tmp_path):
    """update_period = 2: four batches, two updates; the summed grads,
    the 1 / (batch * period) loss scale and the update counter match."""
    _write_corpus(tmp_path / "c.tok")
    batches = _batches(tmp_path / "c.tok", 4)
    jt, tt = _trainer_pair("sgd", extra=[("update_period", "2")])
    for batch in batches:
        jt.update(batch)
        tt.update(batch)
        assert abs(float(tt.last_loss) - float(jt._last_loss)) \
            <= 1e-5 * abs(float(jt._last_loss))
    assert tt.epoch_counter == jt.epoch_counter == 2
    for key, group in jt.params.items():
        for tag, v in group.items():
            np.testing.assert_allclose(tt.params[key][tag].numpy(),
                                       np.asarray(v), atol=1e-5)


def _train_conf(tmp_path, name, model_in):
    return (f"dev = cpu\ntask = train\nmodel_in = {model_in}\n"
            f"model_dir = {tmp_path}/{name}\n"
            f"data = train\niter = text\n  path_tok = {tmp_path}/c.tok\n"
            "iter = packseq\n  seqlen = 128\niter = end\n"
            f"{_packed_net()}\nbatch_size = 2\nupdater = sgd\neta = 0.01\n"
            "num_round = 1\nsave_model = 1\neval_train = 0\n"
            "print_step = 2\nsilent = 1\n"
            f"metrics_sink = jsonl:{tmp_path}/{name}.jsonl\n")


def test_cli_train_matches_jax_cli_and_loads_in_jax(tmp_path):
    """task = train through both CLIs from one JAX-written 0000.model on
    the same corpus (dev = cpu, sgd): the 0001.model params agree within
    1e-5, the port's snapshot (with its sgd state) loads in the JAX
    package, and the port writes a step record per printed step."""
    import json
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu.nnet.trainer import NetTrainer as JNetTrainer
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils import serializer
    _write_corpus(tmp_path / "c.tok", ndocs=40)
    jt, _ = _trainer_pair("sgd")
    init = str(tmp_path / "0000.model")
    jt.save_model(init)
    for name, task in (("jax", JTask), ("port", TTask)):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(_train_conf(tmp_path, name, init))
        t = task()
        assert t.run([str(conf)]) == 0
    port_model = str(tmp_path / "port" / "0001.model")
    _, want, _, _ = serializer.load_model(str(tmp_path / "jax" / "0001.model"))
    header, got, _, opt = serializer.load_model(port_model)
    assert header["has_opt_state"] and set(opt) == set(got)
    for key, group in want.items():
        for tag, v in group.items():
            np.testing.assert_allclose(got[key][tag], v, atol=1e-5,
                                       err_msg=f"{key}/{tag}")
    j2 = JNetTrainer()
    for k, v in (("batch_size", "2"), ("dev", "cpu"), ("silent", "1"),
                 ("updater", "sgd")):
        j2.set_param(k, v)
    j2.load_model(port_model)
    assert j2.epoch_counter == header["epoch"] > 0
    for key, group in j2.params.items():
        for tag, v in group.items():
            assert np.array_equal(np.asarray(v), got[key][tag])
    recs = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    steps = [r for r in recs if r["kind"] == "step"]
    assert steps and all(np.isfinite(r["loss"]) and r["dispatch_sec"] > 0
                         and r["examples_per_sec"] > 0 for r in steps)


@pytest.mark.parametrize("key,val", [("test_on_server", "1"),
                                     ("shard_opt_state", "1"),
                                     ("fullc_gather", "1"),
                                     ("mesh", "data:2")])
def test_unported_train_keys_are_refused(tmp_path, key, val):
    """The multi-GPU plane's keys of the JAX train loop, refused until
    the data-parallel plane was ported, run on one device as in the JAX
    package (ZeRO and the model axis need a mesh axis wider than 1; the
    replica check passes on one replica); a mesh of more devices than
    the run selects is refused with the count it needs."""
    from cxxnet_tpu_torch.main import LearnTask
    _write_corpus(tmp_path / "c.tok", ndocs=10)
    conf = tmp_path / "t.conf"
    conf.write_text(_train_conf(tmp_path, "m", "NULL"))
    if key == "mesh":
        with pytest.raises(ValueError, match="needs 2 ranks"):
            LearnTask().run([str(conf), f"{key}={val}"])
        return
    assert LearnTask().run([str(conf), f"{key}={val}"]) == 0


# ------------------------------------------------- attention routing

@pytest.mark.parametrize("flash", ["1", "0"])
def test_attention_with_segments_routes_by_flash_attn(flash, monkeypatch):
    """flash_attn = 1 with causal segment ids goes through the segmented
    flash Function (never dense_attention); flash_attn = 0 goes to
    dense_attention.  Both give the same output and input gradients.
    Non-causal attention with segment ids takes dense_attention under
    flash_attn = 1 too, as the JAX package routes it."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers import sequence as tseq
    from cxxnet_tpu_torch.layers.base import ForwardContext, LabelInfo
    calls = {"seg": 0, "dense": 0}
    real_seg, real_dense = fa.flash_attention_seg_fwd, tseq.ring.dense_attention

    def seg_spy(*a, **kw):
        calls["seg"] += 1
        return real_seg(*a, **kw)

    def dense_spy(*a, **kw):
        calls["dense"] += 1
        return real_dense(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_seg_fwd", seg_spy)
    monkeypatch.setattr(tseq.ring, "dense_attention", dense_spy)
    rnd = np.random.RandomState(22)
    layer = tseq.AttentionLayer()
    for k, v in (("nhead", "2"), ("causal", "1"), ("segment_key", "seg")):
        layer.set_param(k, v)
    x = _t(rnd.randn(2, 1, 16, 8).astype(np.float32)).requires_grad_()
    params = layer.init_params(torch.Generator().manual_seed(0),
                               [(2, 1, 16, 8)])
    seg = _t(np.array([[1] * 9 + [2] * 7, [1] * 12 + [0] * 4], np.float32))
    opts = EngineOptions()
    opts.set("flash_attn", flash)
    ctx = ForwardContext(train=True, opts=opts,
                         labels=LabelInfo(fields={"seg": seg}))
    [out] = layer.forward(params, [x], ctx)
    (gx,) = torch.autograd.grad(out.square().sum(), [x])
    assert calls == ({"seg": 1, "dense": 0} if flash == "1"
                     else {"seg": 0, "dense": 1})
    opts.set("flash_attn", "0" if flash == "1" else "1")
    [ref] = layer.forward(params, [x], ctx)
    (gref,) = torch.autograd.grad(ref.square().sum(), [x])
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gx, gref, atol=1e-5, rtol=1e-5)
    layer.set_param("causal", "0")
    opts.set("flash_attn", "1")
    calls.update(seg=0, dense=0)
    [out] = layer.forward(params, [x], ctx)
    assert calls == {"seg": 0, "dense": 1}
    opts.set("flash_attn", "0")
    [ref] = layer.forward(params, [x], ctx)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


# ------------------------------------------------------------ fused adam

def _bf16_within_step(p, p_ref, w, w_ref):
    """Each bf16 param within one bf16 step (2^-7 of its magnitude) of the
    reference, plus the two float32 masters' difference (both params are
    roundings of masters a few ulps apart, which decides a param near
    0)."""
    p, p_ref = np.asarray(p, np.float32), np.asarray(p_ref, np.float32)
    tol = np.maximum(np.abs(p), np.abs(p_ref)) * 2.0 ** -7 + np.abs(
        np.asarray(w, np.float32) - np.asarray(w_ref, np.float32))
    return bool(((np.abs(p - p_ref) <= tol)
                 | (np.isnan(p) & np.isnan(p_ref))).all())


@pytest.mark.parametrize("wd,clip,epoch", [(0.0, 0.0, 0), (0.001, 0.5, 7),
                                           (0.01, 0.0, 3)])
def test_fused_adam_plain_matches_pallas_interpret(wd, clip, epoch):
    """fused_adam_pallas of the port (its plain version on the CPU)
    against the JAX package's (interpret mode) on the same (16, 1024)
    bf16 param, float32 state and bias-corrected lr_t, three chained
    steps with an over-clip gradient (and under a clip a NaN): m1, m2 and
    the master within rtol 1e-5, atol 1e-7, the param within one bf16
    step (the JAX package's own tolerances between its two lowerings);
    the port writes its state and param in place.  The port's unfused
    AdamUpdater agrees to the same tolerances."""
    from cxxnet_tpu.updater import updaters as ju
    from cxxnet_tpu_torch.ops import fused_adam as fu
    from cxxnet_tpu_torch.updater import updaters as tu
    rnd = np.random.RandomState(23)
    p0 = (rnd.randn(16, 1024) * 0.1).astype(np.float32)
    jh = ju.UpdaterHyper(tag="wmat", base_lr=0.01, wd=wd,
                         clip_gradient=clip)
    th = tu.UpdaterHyper(**vars(jh))
    jp = jnp.asarray(p0).astype(jnp.bfloat16)
    js = ju.AdamUpdater().make_state(jp)
    tp = _t(p0).to(torch.bfloat16)
    ts = tu.AdamUpdater().make_state(tp)
    up, us = tp.clone(), {k: v.clone() for k, v in ts.items()}
    for step in range(3):
        g = (rnd.randn(16, 1024) * 0.01).astype(np.float32)
        g[0, 1] = 5.0
        if clip:
            g[0, 0] = np.nan
        lr_j = ju.AdamUpdater._lr_t(jh, epoch + step)
        lr_t = tu.AdamUpdater().lr_t(th, epoch + step)
        # float32 bias corrections: numpy's and XLA's pow may differ in
        # the last bit, which 1 - (1 - d2)^t (near 0) amplifies
        assert abs(lr_t - float(lr_j)) <= 1e-5 * float(lr_j)
        jp, m1, m2, w32 = pk.fused_adam_pallas(
            jnp.asarray(g).astype(jnp.bfloat16), js["m1"], js["m2"],
            js["w32"], lr_j, d1=jh.beta1, d2=jh.beta2, wd=wd, clip=clip,
            interpret=True)
        js = {"m1": m1, "m2": m2, "w32": w32}
        tg = _t(g).to(torch.bfloat16)
        out = fu.fused_adam_pallas(tg, ts["m1"], ts["m2"], ts["w32"], lr_t,
                                   d1=th.beta1, d2=th.beta2, wd=wd,
                                   clip=clip, out=tp)
        assert all(a is b for a, b in zip(out, (tp, ts["m1"], ts["m2"],
                                                ts["w32"])))
        tu.AdamUpdater().apply(up, tg, us, th, epoch + step)
        for key in ("m1", "m2", "w32"):
            for got in (ts[key], us[key]):
                np.testing.assert_allclose(got.numpy(), np.asarray(js[key]),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"{key} step {step}")
        assert torch.equal(tp, ts["w32"].to(torch.bfloat16))
        for p, st in ((tp, ts), (up, us)):
            assert _bf16_within_step(p.float().numpy(), np.asarray(
                jp, np.float32), st["w32"].numpy(), np.asarray(js["w32"]))
    assert fu.fused_adam_pallas.launches == 0


@pytest.mark.parametrize("shape,dtype", [
    ((16, 1024), "bfloat16"), ((16, 1024), "float32"),
    ((3, 1000), "bfloat16"), ((8192,), "bfloat16"),
    ((2, 3, 8192), "bfloat16"), ((4096,), "bfloat16"),
    ((256, 128), "bfloat16"), ((384,), "bfloat16")])
def test_fused_adam_supported_matches_jax(shape, dtype):
    """Both packages' gates admit the same tensors (bf16, size a multiple
    of 8 x 1024), so under fused_update = 1 they fuse the same ones."""
    from cxxnet_tpu_torch.ops.fused_adam import fused_adam_supported
    want = pk.fused_adam_supported(jnp.zeros(shape, getattr(jnp, dtype)))
    assert fused_adam_supported(torch.zeros(shape,
                                            dtype=getattr(torch, dtype))) \
        == want == (dtype == "bfloat16" and int(np.prod(shape)) % 8192 == 0)


@pytest.mark.parametrize("shape,dtype,master,fused", [
    ((16, 1024), torch.bfloat16, True, True),    # admitted
    ((3, 1000), torch.bfloat16, True, False),    # size off the gate
    ((16, 1024), torch.float32, False, False),   # no master
])
def test_adam_fused_flag_routes_by_the_gate(monkeypatch, shape, dtype,
                                            master, fused):
    """AdamUpdater.apply(fused=True) sends exactly the admitted tensors
    through fused_adam_pallas; the others take the unfused update,
    bitwise the same as without the flag."""
    from cxxnet_tpu_torch.updater import updaters as tu
    calls = []
    real = tu.fused_adam_pallas
    monkeypatch.setattr(tu, "fused_adam_pallas",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rnd = np.random.RandomState(24)
    p = _t((rnd.randn(*shape) * 0.1).astype(np.float32)).to(dtype)
    g = _t((rnd.randn(*shape) * 0.01).astype(np.float32)).to(dtype)
    up = tu.AdamUpdater()
    h = tu.UpdaterHyper(tag="wmat", base_lr=0.01)
    st = up.make_state(p)
    assert ("w32" in st) == master
    ref_p, ref_st = p.clone(), {k: v.clone() for k, v in st.items()}
    up.apply(p, g, st, h, 2, fused=True)
    up.apply(ref_p, g, ref_st, h, 2)
    assert len(calls) == int(fused) and sorted(st) == sorted(ref_st)
    if not fused:
        assert torch.equal(p, ref_p)
    for k in st:
        torch.testing.assert_close(st[k], ref_st[k], rtol=1e-5, atol=1e-7)


def _fused_lm_net():
    from cxxnet_tpu_torch.models import transformer
    return transformer(vocab=256, seq=128, dim=128, nlayer=2, nhead=2,
                       packed=True)


def _fused_lm_batches(path, n):
    from cxxnet_tpu_torch.io.text import write_token_shard
    rnd = np.random.RandomState(25)
    write_token_shard(str(path), [rnd.randint(0, 256, rnd.randint(10, 90))
                                  for _ in range(40)], itemsize=2)
    return _batches(path, n)


@pytest.fixture
def jopts():
    """The JAX package's process-global engine options (a trainer's
    ``fused_update`` key sets them), restored after the test."""
    from cxxnet_tpu import engine as jengine
    saved = jengine.snapshot()
    yield jengine.opts
    for k, v in saved.items():
        jengine.opts.set(k, v)


def _fused_pair(keys):
    """(JAX trainer, port trainer) on the narrow bf16 LM (d128, vocab 256,
    2 layers: every matrix tiles by 8192), the port's params from the
    JAX trainer's."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = _fused_lm_net()
    jt = _make_trainer(net, 2, "cpu", extra=keys)
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in [("batch_size", "2"), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


_FUSED_KEYS = [("updater", "adam"), ("eta", "0.001"), ("dtype", "bfloat16"),
               ("fused_update", "1"), ("eval_train", "0"), ("silent", "1")]


@pytest.mark.parametrize("period", [1, 2])
def test_fused_update_lm_matches_jax(jopts, monkeypatch, tmp_path, period):
    """The narrow bf16 LM under ``fused_update = 1`` (and update_period =
    ``period``) stepped twice by both trainers from one snapshot: each
    port update sends the 11 admitted matrices (of 29 tensors) through
    fused_adam_pallas and the JAX trainer traces its Pallas kernel for
    the same ones; the losses agree within rel 1e-4 (bf16 forwards); the
    masters within 2 x eta per update (adam moves a parameter at most
    ~eta a step, and an element whose bf16 gradients straddle zero in
    the two packages moves either way); m1 and m2 within 0.1 of their
    largest element (the two packages' bf16 gradients differ in the last
    bits)."""
    from cxxnet_tpu_torch.ops.fused_adam import fused_adam_supported
    from cxxnet_tpu_torch.updater import updaters as tu
    calls = {"jax": 0, "port": 0}
    real_j, real_t = pk.fused_adam_pallas, tu.fused_adam_pallas

    def spy(which, real):
        def f(*a, **kw):
            calls[which] += 1
            return real(*a, **kw)
        return f

    monkeypatch.setattr(pk, "fused_adam_pallas", spy("jax", real_j))
    monkeypatch.setattr(tu, "fused_adam_pallas", spy("port", real_t))
    batches = _fused_lm_batches(tmp_path / "c.tok", 2 * period)
    jt, tt = _fused_pair(_FUSED_KEYS + [("update_period", str(period))])
    admitted = sum(fused_adam_supported(p) for g in tt.params.values()
                   for p in g.values())
    assert admitted == 11
    for batch in batches:
        jt.update(batch)
        tt.update(batch)
        jl, tl = float(jt._last_loss), float(tt.last_loss)
        assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert tt.epoch_counter == jt.epoch_counter == 2
    assert calls["port"] == 2 * admitted and calls["jax"] >= admitted
    for key, group in jt.opt_state.items():
        for tag, st in group.items():
            assert set(st) == set(tt.opt_state[key][tag]) == {"m1", "m2",
                                                              "w32"}
            w = np.asarray(st["w32"])
            got = tt.opt_state[key][tag]
            assert np.abs(got["w32"].numpy() - w).max() <= 2 * 2 * 1e-3
            np.testing.assert_array_equal(
                tt.params[key][tag].float().numpy(),
                got["w32"].to(torch.bfloat16).float().numpy())
            for m in ("m1", "m2"):
                ref = np.asarray(st[m])
                assert _max_rel(got[m].numpy(), ref) <= 0.1, (key, tag, m)


def test_fused_update_equals_unfused_in_the_port(jopts, tmp_path):
    """In the port, the same bf16 LM from one snapshot stepped twice with
    and without ``fused_update``: the same losses bitwise (the first
    update's gradients are the same), and every param, master and moment
    within rtol 1e-5, atol 1e-7 of the unfused update's."""
    batches = _fused_lm_batches(tmp_path / "c.tok", 2)
    _, fused = _fused_pair(_FUSED_KEYS)
    _, plain = _fused_pair([kv for kv in _FUSED_KEYS
                            if kv[0] != "fused_update"])
    assert plain.opts.fused_update == "0"
    for batch in batches:
        fused.update(batch)
        plain.update(batch)
    assert float(fused.last_loss) == pytest.approx(float(plain.last_loss),
                                                   rel=1e-6)
    for key, group in plain.opt_state.items():
        for tag, st in group.items():
            for k, v in st.items():
                torch.testing.assert_close(fused.opt_state[key][tag][k], v,
                                           rtol=1e-5, atol=1e-7)


def test_fused_snapshot_crosses_from_jax(jopts, tmp_path):
    """One fused step in the JAX trainer saved with its optimizer state:
    the port loads m1, m2 and w32 bitwise under the same keys, and its
    fused updates go on from them (two more steps, losses within rel
    1e-4 of the JAX trainer's)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    batches = _fused_lm_batches(tmp_path / "c.tok", 3)
    jt, _ = _fused_pair(_FUSED_KEYS)
    jt.update(batches[0])
    path = str(tmp_path / "j.model")
    jt.save_model(path, with_opt_state=True)
    tt = NetTrainer()
    for k, v in [("batch_size", "2"), ("dev", "cpu")] + _FUSED_KEYS:
        tt.set_param(k, v)
    tt.load_model(path)
    tt._ensure_opt_state()
    for key, group in jt.opt_state.items():
        for tag, st in group.items():
            for k, v in st.items():
                np.testing.assert_array_equal(
                    tt.opt_state[key][tag][k].numpy(), np.asarray(v))
    for batch in batches[1:]:
        jt.update(batch)
        tt.update(batch)
        jl = float(jt._last_loss)
        assert abs(float(tt.last_loss) - jl) <= 1e-4 * abs(jl)

"""Routes of the port's kernels where their domain ends, on the CPU.

Attention: ``attention_route`` sends a call to plain dense attention
exactly where the JAX package's ``_single_device_attention`` does
(non-causal attention with segment ids, head widths above 256); every
other call takes a flash Function, which widens a head width off the
kernels' multiples of 8 with zero columns.  The layer calls a flash
Function or dense attention as the route says, and a depth-1 LM trains
in both packages to the same losses and gradients at head widths 12
(widened) and 264 (dense).  LRN: the plain backward, which the CUDA
kernel is held to on the card, against the Pallas kernels (interpret
mode) at windows wider than 32 channels and wider than C.  Inputs come
from numpy with a seed.
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
from cxxnet_tpu_torch.ops import lrn  # noqa: E402

#: the port's training envelope (ROADMAP.md): f32 forward, gradients per
#: tensor as max |got - ref| / max |ref|
FWD_TOL, GRAD_TOL = 1e-6, 5e-3
#: the LRN plain versions against Pallas interpret (tests/test_torch_cnn.py)
LRN_FWD_TOL, LRN_GRAD_TOL = 1e-6, 1e-5

F32, BF16 = torch.float32, torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -------------------------------------------------------- attention route

@pytest.mark.parametrize("hd,causal,seg,want", [
    (64, True, False, "flash"),        # example/LM/*.conf
    (64, True, True, "flash_seg"),
    (16, True, True, "flash_seg"),     # example/LM tiny heads
    (16, False, False, "flash"),
    (12, True, False, "flash"),        # widened to 16
    (12, True, True, "flash_seg"),
    (4, False, False, "flash"),        # widened to 8
    (128, True, True, "flash_seg"),
    (136, True, False, "flash"),
    (136, True, True, "flash_seg"),
    (256, True, False, "flash"),       # the reference's widest flash head
    (256, True, True, "flash_seg"),
    (256, False, False, "flash"),
    (264, True, False, "dense"),       # above the reference's 256
    (264, True, True, "dense"),
    (264, False, False, "dense"),
    (64, False, True, "dense"),        # non-causal segments
    (12, False, True, "dense"),
])
def test_attention_route(hd, causal, seg, want):
    """attention_route from the shapes alone; dense_reason names a cause
    exactly where the route is dense."""
    assert fa.attention_route(hd, causal, seg) == want
    reason = fa.dense_reason(hd, causal, seg)
    assert (reason is not None) == (want == "dense")


@pytest.mark.parametrize("d", [1, 4, 12, 100])
@pytest.mark.parametrize("seg", [False, True])
def test_flash_functions_widen_to_a_multiple_of_8(d, seg, monkeypatch):
    """flash_attention / flash_attention_segmented hand the wrappers q,
    k, v widened with zero columns to a multiple of 8 (at least 8) and
    return the output and gradients at the true width, equal to the
    plain versions run at it (float64, so the zero columns' effect on
    the sums' order stays far below the tolerance)."""
    rnd = np.random.RandomState(d)
    q, k, v, do = (_t(rnd.randn(4, 20, d)) for _ in range(4))
    ids = _t(np.array([[1] * 9 + [2] * 7 + [0] * 4, [3] * 20], np.int64))
    widths = []
    name = "flash_attention_seg_fwd" if seg else "flash_attention_fwd"
    real = getattr(fa, name)

    def spy(q_, *a):
        widths.append(q_.shape[-1])
        return real(q_, *a)

    monkeypatch.setattr(fa, name, spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if seg:
        o = fa.flash_attention_segmented(*leaves, ids)
        o_ref, lse = fa.flash_attention_seg_fwd_plain(q, k, v, ids)
        ref = fa.flash_attention_seg_bwd_plain(q, k, v, ids, o_ref, lse, do)
    else:
        o = fa.flash_attention(*leaves, True)
        o_ref, lse = fa.flash_attention_fwd_plain(q, k, v, True)
        ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse, do, True)
    got = torch.autograd.grad(o, leaves, do)
    assert widths == [max(8, d + (-d) % 8)]
    torch.testing.assert_close(o, o_ref, atol=1e-12, rtol=1e-12)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, atol=1e-12, rtol=1e-12)


def _attention(hd, nhead, causal, seg_key, flash, rnd):
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers import sequence as tseq
    from cxxnet_tpu_torch.layers.base import ForwardContext, LabelInfo
    layer = tseq.AttentionLayer()
    for k, v in (("nhead", str(nhead)), ("causal", str(int(causal))),
                 ("segment_key", "seg" if seg_key else "")):
        layer.set_param(k, v)
    d = hd * nhead
    params = layer.init_params(torch.Generator().manual_seed(0),
                               [(2, 1, 16, d)])
    x = _t(rnd.randn(2, 1, 16, d).astype(np.float32))
    seg = _t(np.array([[1] * 9 + [2] * 7, [1] * 12 + [0] * 4], np.float32))
    opts = EngineOptions()
    opts.set("flash_attn", flash)
    ctx = ForwardContext(train=True, opts=opts,
                         labels=LabelInfo(fields={"seg": seg}))
    return layer, params, x, ctx


@pytest.mark.parametrize("hd,nhead,causal,seg,grad,want", [
    (12, 2, True, False, True, "flash"),
    (12, 2, True, True, False, "flash_seg"),
    (264, 1, True, False, False, "dense"),
    (264, 1, True, True, True, "dense"),
    (136, 1, True, True, True, "flash_seg"),
    (136, 1, True, False, False, "flash"),
    (256, 1, True, False, True, "flash"),
    (64, 2, False, True, True, "dense"),
    (16, 2, True, True, True, "flash_seg"),
])
def test_attention_layer_calls_no_flash_function_on_the_dense_route(
        hd, nhead, causal, seg, grad, want, monkeypatch):
    """The attention layer under flash_attn = 1, with and without a
    gradient, calls the flash forward wrappers exactly where the route is
    flash, dense_attention exactly where it is dense (counted in
    dense_routes), and gives the output and input gradient of
    flash_attn = 0."""
    from cxxnet_tpu_torch.layers import sequence as tseq
    calls = {"flash": 0, "flash_seg": 0, "dense": 0}
    real = {"flash": fa.flash_attention_fwd,
            "flash_seg": fa.flash_attention_seg_fwd,
            "dense": tseq.ring.dense_attention}

    def spy(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    monkeypatch.setattr(fa, "flash_attention_fwd", spy("flash"))
    monkeypatch.setattr(fa, "flash_attention_seg_fwd", spy("flash_seg"))
    monkeypatch.setattr(tseq.ring, "dense_attention", spy("dense"))
    monkeypatch.setattr(tseq.single_device_attention, "dense_routes", 0)
    layer, params, x, ctx = _attention(hd, nhead, causal, seg, "1",
                                       np.random.RandomState(hd))
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        [out] = layer.forward(params, [x], ctx)
    assert calls == {k: int(k == want) for k in calls}
    assert tseq.single_device_attention.dense_routes == int(want == "dense")
    ctx.opts.set("flash_attn", "0")
    with torch.set_grad_enabled(grad):
        [ref] = layer.forward(params, [x], ctx)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    if grad:
        g = _t(np.random.RandomState(1).randn(*out.shape).astype(np.float32))
        (gx,) = torch.autograd.grad(out, [x], g)
        (gref,) = torch.autograd.grad(ref, [x], g)
        torch.testing.assert_close(gx, gref, atol=1e-5, rtol=1e-5)


def _lm_pair(dim, nhead, tmp_path):
    """(JAX trainer, port trainer, batch) of a depth-1 packed LM (vocab
    64, s 32, f32, batch 2), the same weights and one packseq batch."""
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_jax
    from cxxnet_tpu_torch.utils.config import parse_config_string
    rnd = np.random.RandomState(31)
    path = str(tmp_path / "c.tok")
    write_token_shard(path, [rnd.randint(0, 64, rnd.randint(5, 30))
                             for _ in range(8)], itemsize=2)
    it = init_iterator(create_iterator(
        [("iter", "text"), ("path_tok", path), ("iter", "packseq"),
         ("seqlen", "32"), ("iter", "end")]),
        [("batch_size", "2"), ("silent", "1")])
    it.before_first()
    batch = it.next()
    net = transformer(vocab=64, seq=32, dim=dim, nlayer=1, nhead=nhead,
                      packed=True)
    keys = [("updater", "sgd"), ("eta", "0.01"), ("eval_train", "0"),
            ("silent", "1")]
    jt = _make_trainer(net, 2, "cpu", extra=keys)
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in [("batch_size", "2"), ("dev", "cpu")] + keys:
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt, batch


@pytest.mark.parametrize("hd,nhead,want", [(12, 2, "flash_seg"),
                                          (264, 1, "dense")])
def test_lm_off_the_kernels_widths_matches_jax(hd, nhead, want, tmp_path,
                                               monkeypatch):
    """A depth-1 packed LM at head width 12 (not a multiple of 8: the
    segmented flash Function, widened) and 264 (above every flash kernel:
    dense attention), f32: the port under flash_attn = 1 takes that route
    and its loss and step gradients match the JAX trainer's, whose
    _single_device_attention runs dense attention off the TPU: loss
    FWD_TOL, each gradient GRAD_TOL."""
    from cxxnet_tpu_torch.layers import sequence as tseq
    jt, tt, batch = _lm_pair(hd * nhead, nhead, tmp_path)
    assert tt.opts.flash_attn == "1"
    calls = {"flash_seg": 0}
    real = fa.flash_attention_seg_fwd

    def spy(*a):
        calls["flash_seg"] += 1
        return real(*a)

    monkeypatch.setattr(fa, "flash_attention_seg_fwd", spy)
    monkeypatch.setattr(fa, "flash_attention_fwd", None)  # a call raises
    monkeypatch.setattr(tseq.single_device_attention, "dense_routes", 0)
    (jloss, _), jgrads = jt._loss_and_grads(
        jt.params, jt.buffers, jnp.asarray(batch.data),
        jnp.asarray(batch.label, jnp.float32), (), jnp.int32(0),
        jax.random.PRNGKey(0), ())
    tloss, tgrads = tt.loss_and_grads(batch)
    assert (tseq.single_device_attention.dense_routes,
            calls["flash_seg"]) == ((1, 0) if want == "dense" else (0, 1))
    assert abs(float(tloss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    assert set(tgrads) == set(jgrads)
    for key, group in jgrads.items():
        for tag, g in group.items():
            g = np.asarray(g)
            err = float(np.abs(tgrads[key][tag].numpy() - g).max()
                        / max(np.abs(g).max(), 1e-30))
            assert err <= GRAD_TOL, (key, tag, err)


# ------------------------------------------------------- LRN wide windows

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("nsize", [33, 64, 43])   # 43 = C + 3
@pytest.mark.parametrize("layout", ["nchw", "hwcn"])
def test_lrn_bwd_plain_matches_pallas_at_wide_windows(nsize, layout):
    """lrn_bwd_plain (NCHW) and lrn_hwcn_bwd_plain ((H, W, C, N)), the
    versions the CUDA backward is held to on the card, against the JAX
    package's lrn_pallas vjp in interpret mode at C = 40 and windows of
    33, 64 and C + 3 channels: forward LRN_FWD_TOL, dx LRN_GRAD_TOL.
    (The JAX package's (H, W, C, N) kernel takes windows up to its
    8-channel halo only; the function is the same in both layouts.)"""
    rnd = np.random.RandomState(nsize)
    x = (rnd.randn(2, 40, 3, 4) * 2).astype(np.float32)
    g = rnd.randn(*x.shape).astype(np.float32)
    args = (nsize, 0.01, 0.75, 1.0)
    y_j, vjp = jax.vjp(lambda v: pk.lrn_pallas(v, *args), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    if layout == "nchw":
        y_t = lrn.lrn_fwd_plain(_t(x), *args)
        dx_t = lrn.lrn_bwd_plain(_t(x), _t(g), *args)
    else:
        xt = _t(x).permute(lrn.TO_HWCN).contiguous()
        gt = _t(g).permute(lrn.TO_HWCN).contiguous()
        y_t = lrn.lrn_hwcn_fwd_plain(xt, *args).permute(lrn.FROM_HWCN)
        dx_t = lrn.lrn_hwcn_bwd_plain(xt, gt, *args).permute(lrn.FROM_HWCN)
    assert _rel(y_t, y_j) <= LRN_FWD_TOL
    assert _rel(dx_t, dx_j) <= LRN_GRAD_TOL

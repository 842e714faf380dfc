"""The port's kernel modules against the JAX package, on the CPU.

Each kernel of cxxnet_tpu_torch has a plain PyTorch version beside it;
on the CPU the wrapper runs that version.  These tests hold the plain
versions to the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them), and the plain attention / layernorm
paths of the port's layers to the JAX package's own off-TPU paths.
Inputs are made with numpy from a seed and handed to both sides.  The
CUDA kernels themselves are checked on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from cxxnet_tpu.parallel import ring as jring  # noqa: E402
from cxxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402
from cxxnet_tpu_torch.parallel import ring as tring  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- flash

@pytest.mark.parametrize("causal,d", [
    pytest.param(True, 64, id="True"), pytest.param(False, 64, id="False"),
    pytest.param(True, 256, id="True-d256"),
    pytest.param(False, 256, id="False-d256")])
def test_flash_plain_matches_pallas_interpret(causal, d):
    """flash_attention_fwd_plain == the Pallas flash forward (interpret
    mode) at b2/h2/s256 f32, head width 64 and 256 (the reference's
    d > 128 blocks; the plain version is what the kernels are held to on
    the card at both): o and lse within 1e-5."""
    rnd = np.random.RandomState(3)
    b, h, s = 2, 2, 256
    q, k, v = (rnd.randn(b, h, s, d).astype(np.float32) * 0.5
               for _ in range(3))
    o_j = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, None, True)
    _, res = pk._flash_fwd_res(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, None, True)
    lse_j = np.asarray(res[4])                       # (b*h, 1, s)
    o_t, lse_t = fa.flash_attention_fwd_plain(
        _t(q.reshape(b * h, s, d)), _t(k.reshape(b * h, s, d)),
        _t(v.reshape(b * h, s, d)), causal)
    np.testing.assert_allclose(o_t.numpy().reshape(b, h, s, d),
                               np.asarray(o_j), atol=1e-5)
    assert lse_t.shape == lse_j.shape
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-5)


def test_flash_wrapper_uses_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    rnd = np.random.RandomState(4)
    q, k, v = (_t(rnd.randn(3, 40, 24).astype(np.float32)) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o2, lse2 = fa.flash_attention_fwd_plain(q, k, v, True)
    assert fa.flash_attention_fwd.launches == before
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert fa.flash_attention_supported(128)
    assert not fa.flash_attention_supported(12)
    assert not fa.flash_attention_supported(264)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_bf16_rounds_p_like_the_kernel(dtype):
    """p is cast to v's dtype before p·V: in bf16 the plain version
    agrees with the JAX dense path within the bf16 envelope and o comes
    back in q's dtype."""
    rnd = np.random.RandomState(5)
    q, k, v = (rnd.randn(1, 2, 128, 32).astype(np.float32) for _ in range(3))
    tdt = getattr(torch, dtype)
    qt, kt, vt = (_t(a.reshape(2, 128, 32)).to(tdt) for a in (q, k, v))
    o, _ = fa.flash_attention_fwd_plain(qt, kt, vt, True)
    assert o.dtype == tdt
    jdt = getattr(jnp, dtype)
    ref = jring.dense_attention(*(jnp.asarray(a).astype(jdt)
                                  for a in (q, k, v)), causal=True)
    ref = np.asarray(ref, np.float32).reshape(2, 128, 32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    err = np.abs(o.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(chunked, causal, monkeypatch):
    """The port's plain attention path == ring.dense_attention, on the
    direct and on the chunked online-softmax path."""
    if chunked:
        monkeypatch.setattr(jring, "CHUNKED_ATTN_THRESHOLD", 64)
        monkeypatch.setattr(tring, "CHUNKED_ATTN_THRESHOLD", 64)
    rnd = np.random.RandomState(6)
    q, k, v = (rnd.randn(2, 2, 256, 16).astype(np.float32) for _ in range(3))
    ref = jring.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    got = tring.dense_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_dense_attention_segment_mask_matches_jax():
    rnd = np.random.RandomState(7)
    q, k, v = (rnd.randn(2, 2, 32, 8).astype(np.float32) for _ in range(3))
    seg = np.sort(rnd.randint(0, 4, (2, 32)), axis=1).astype(np.int32)
    ref = jring.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                seg=jnp.asarray(seg))
    got = tring.dense_attention(_t(q), _t(k), _t(v), causal=True,
                                seg=_t(seg).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------- layernorm

def _ln_inputs(rows, d, seed=8):
    rnd = np.random.RandomState(seed)
    x = rnd.randn(rows, d).astype(np.float32)
    # high-mean rows, where E[x^2]-E[x]^2 would cancel and the two-pass
    # variance matters; dyadic values keep their float32 sums exact in
    # any order, so the comparison sees the algorithm, not the order
    x[::7] = 300.0 + rnd.randint(-64, 65, x[::7].shape) / 16.0
    x[1::7] *= 1e-3
    g = (rnd.rand(d) + 0.5).astype(np.float32)
    b = (rnd.randn(d) * 0.5).astype(np.float32)
    return x, g, b


def test_layernorm_plain_matches_pallas_interpret():
    """layernorm_fwd_plain == layernorm_pallas (interpret mode) at rows
    256 / d 128 f32, high-mean rows included: y, mean, rstd within 1e-6
    (rstd relative)."""
    x, g, b = _ln_inputs(256, 128)
    y_j = pk.layernorm_pallas(jnp.asarray(x), jnp.asarray(g),
                              jnp.asarray(b), 1e-5, True)
    _, res = pk._ln_fwd_res(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            1e-5, True, save_x=True)
    y_t, mean_t, rstd_t = ln.layernorm_fwd_plain(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(res[2]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(res[3]),
                               rtol=1e-6)


def test_layernorm_wrapper_uses_plain_version_on_cpu():
    x, g, b = _ln_inputs(5, 24)
    before = ln.layernorm_fwd.launches
    got = ln.layernorm_fwd(_t(x), _t(g), _t(b), 1e-5)
    want = ln.layernorm_fwd_plain(_t(x), _t(g), _t(b), 1e-5)
    assert ln.layernorm_fwd.launches == before
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert got[1].shape == (5, 1) and got[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pallas_ln", ["1", "0"])
def test_layernorm_layer_matches_jax_layer(dtype, pallas_ln):
    """The port's layernorm layer, on the kernel route (plain version on
    the CPU) and on the plain path (pallas_ln = 0, single-pass moments in
    bf16 like the JAX lowering), against the JAX layer's CPU forward."""
    from cxxnet_tpu.layers.base import ForwardContext as JCtx
    from cxxnet_tpu.layers.sequence import LayerNormLayer as JLN
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.base import ForwardContext as TCtx
    from cxxnet_tpu_torch.layers.sequence import LayerNormLayer as TLN
    x, g, b = _ln_inputs(12, 64, seed=9)
    x[::7] -= 300.0          # keep the bf16 inputs well scaled
    x = x.reshape(2, 1, 6, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {"wmat": jnp.asarray(g).astype(jdt), "bias": jnp.asarray(b).astype(jdt)}
    [ref], _ = JLN().forward(jp, {}, [jnp.asarray(x).astype(jdt)],
                             JCtx(train=False))
    opts = EngineOptions()
    opts.set("pallas_ln", pallas_ln)
    tp = {"wmat": _t(g).to(tdt), "bias": _t(b).to(tdt)}
    [got] = TLN().forward(tp, [_t(x).to(tdt)],
                          TCtx(train=False, opts=opts))
    assert got.dtype == tdt
    ref = np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol

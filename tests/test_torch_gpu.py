"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA
device; on a machine with one card:

    python -m pytest tests/test_torch_gpu.py -q

This file imports only torch and the port (no JAX), so it runs where
JAX is not installed.  chip_smoke.py repeats the comparison at the
served model's shapes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu_torch.ops import conv_wgrad as cw  # noqa: E402
from cxxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from cxxnet_tpu_torch.ops import fused_adam as fu  # noqa: E402
from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402
from cxxnet_tpu_torch.ops import lrn  # noqa: E402
from cxxnet_tpu_torch.ops import pool  # noqa: E402

pytestmark = pytest.mark.gpu

# float32 outputs: max |got - ref| / max |ref|.  bf16 outputs: the same
# per row, within two bf16 ulps of the row's largest element (one ulp of
# a value is at most 2^-7 of it), so a wrong tile in a row of small
# values cannot hide under the largest value of the tensor.
F32_TOL, BF16_ROW_TOL = 1e-4, 2.0 ** -6
# bf16 attention gradients per row: four ulps (p and ds are rounded to
# bf16 on both sides from float32 values that differ in the last bits),
# the row's denominator floored at 2^-10 of the tensor's largest value
# (a query that attends only to itself has an exactly-zero gradient)
BF16_GRAD_ROW_TOL, GRAD_ROW_FLOOR = 2.0 ** -5, 2.0 ** -10
# conv wgrad (dW, db in float32 from either dtype): max |diff| / max |ref|;
# both sides sum float32 products (exact for bf16 inputs) over N*OH*OW
# positions in different orders
WGRAD_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def _row_rel(a, b, floor=0.0):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    den = b.abs().amax(1).clamp_min(max(1e-6, floor * float(b.abs().max())))
    return float(((a - b).abs().amax(1) / den).max())


def _grads_close(got, ref, dtype):
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            assert _rel(g, r) <= F32_TOL
        else:
            assert _row_rel(g, r, GRAD_ROW_FLOOR) <= BF16_GRAD_ROW_TOL


def _at_offset(t, offset):
    """A copy of t whose storage starts ``offset`` elements past a fresh
    (16-byte aligned) allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def _segments(b, s, gen):
    """(b, s) int64 ids: documents of random lengths, a padding tail."""
    seg = torch.zeros((b, s), dtype=torch.int64)
    lens = torch.randint(1, max(2, s // 3), (b, 8), generator=gen)
    for r in range(b):
        pos, k = 0, 1
        end = s - (r * 7) % max(1, s // 4)
        for n in lens[r].tolist():
            if pos >= end:
                break
            seg[r, pos:min(pos + n, end)] = k
            pos, k = pos + n, k + 1
    return seg.cuda()


@pytest.mark.parametrize("shape,causal", [
    ((3, 200, 64), True),        # ragged last tile
    ((2, 128, 8), True),         # narrowest head
    ((1, 77, 256), False),       # widest head, ragged
    ((4, 64, 40), False),        # head width not a multiple of 32
    ((2, 130, 136), True),       # d % 16 == 8 above 128, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dtype)
               for _ in range(3))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.shape == (shape[0], 1, shape[1])
    if dtype == torch.float32:
        assert _rel(o, o_ref) <= F32_TOL
    else:
        assert _row_rel(o, o_ref) <= BF16_ROW_TOL
    assert _rel(lse, lse_ref) <= F32_TOL


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 16, 12), device="cuda")
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention_fwd(q, q, q, True)
    q = torch.zeros((2, 16, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_fwd(q, q, q, True)
    q = torch.zeros((2 * 16 * 16 + 1,), device="cuda", dtype=torch.bfloat16)
    q = q[1:].view(2, 16, 16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(q, q, q, True)


@pytest.mark.parametrize("rows,d", [(1, 1), (5, 130), (4, 2048),
                                    (300, 2048), (3, 20000)])
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_layernorm_kernel_matches_plain(cuda, rows, d, xdt, gdt):
    x = (torch.randn((rows, d), generator=cuda, device="cuda") * 2 + 3)
    x = x.to(xdt)
    g = (torch.rand((d,), generator=cuda, device="cuda") + 0.5).to(gdt)
    b = torch.randn((d,), generator=cuda, device="cuda").to(gdt)
    before = ln.layernorm_fwd.launches
    y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
    y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.layernorm_fwd.launches == before + 1
    assert y.dtype == xdt and mean.shape == (rows, 1)
    if xdt == torch.float32:
        assert _rel(y, y_ref) <= F32_TOL
    else:
        assert _row_rel(y, y_ref) <= BF16_ROW_TOL
    assert _rel(mean, m_ref) <= F32_TOL and _rel(rstd, r_ref) <= F32_TOL


# -------------------------------------------------------- training kernels

@pytest.mark.parametrize("shape,causal", [
    ((3, 200, 64), True),        # ragged last tile
    ((2, 128, 8), True),         # narrowest head
    ((1, 77, 128), False),       # widest wgmma head, ragged
    ((4, 64, 40), False),        # head width not a multiple of 32
    ((2, 320, 128), True),       # several tiles per row and column
    ((2, 130, 136), True),       # above 128 columns, ragged: the wide
                                 # wgmma tiles (bf16), the CUDA cores'
                                 # 32-row tiles (float32)
    ((1, 77, 256), False),       # widest head
    ((2, 200, 192), True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, ref, dtype)


@pytest.mark.parametrize("b,h,s,d", [(2, 2, 200, 64), (1, 3, 320, 128),
                                     (2, 1, 96, 32), (2, 2, 200, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_seg_kernels_match_plain(cuda, b, h, s, d, dtype):
    q, k, v, do = (torch.randn((b * h, s, d), generator=cuda, device="cuda")
                   .to(dtype) for _ in range(4))
    seg = _segments(b, s, torch.Generator().manual_seed(s))
    before = (fa.flash_attention_seg_fwd.launches,
              fa.flash_attention_seg_bwd.launches)
    o, lse = fa.flash_attention_seg_fwd(q, k, v, seg)
    o_ref, lse_ref = fa.flash_attention_seg_fwd_plain(q, k, v, seg)
    got = fa.flash_attention_seg_bwd(q, k, v, seg, o, lse, do)
    ref = fa.flash_attention_seg_bwd_plain(q, k, v, seg, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_seg_fwd.launches,
            fa.flash_attention_seg_bwd.launches) == (before[0] + 1,
                                                     before[1] + 1)
    if dtype == torch.float32:
        assert _rel(o, o_ref) <= F32_TOL
    else:
        assert _row_rel(o, o_ref) <= BF16_ROW_TOL
    assert _rel(lse, lse_ref) <= F32_TOL
    _grads_close(got, ref, dtype)


def test_flash_functions_backward_through_the_kernels(cuda):
    """autograd through FlashAttention / FlashAttentionSegmented launches
    one forward and one backward kernel each."""
    q, k, v = (torch.randn((4, 128, 64), generator=cuda, device="cuda",
                           dtype=torch.float32).requires_grad_()
               for _ in range(3))
    seg = _segments(2, 128, torch.Generator().manual_seed(1))
    counts = lambda: (fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches,
                      fa.flash_attention_seg_fwd.launches,
                      fa.flash_attention_seg_bwd.launches)
    before = counts()
    fa.flash_attention(q, k, v, True).sum().backward()
    fa.flash_attention_segmented(q, k, v, seg).sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)


def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    lse = torch.zeros((2, 1, 16), device="cuda")
    for d in (12, 264):
        q = torch.zeros((2, 16, d), device="cuda")
        with pytest.raises(ValueError, match="head width"):
            fa.flash_attention_bwd(q, q, q, q, lse, q, True)
    q = torch.zeros((2, 16, 16), device="cuda")
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, lse[:, :, :8], q, True)
    with pytest.raises(ValueError, match="segment ids"):
        fa.flash_attention_seg_fwd(q, q, q, torch.ones((3, 16),
                                                       device="cuda"))


# ------------------------------------------- the wgmma kernels' tile edges
# The bf16 forward takes 128 query rows a block (two consumers of 64) and
# 128-row K / V stages up to 128 columns, 64-row stages wider (the
# block's last causal stage then lies above consumer 0's rows); the dq
# kernel 128 query rows and 64-row K / V stages, the dk/dv kernel 128 key
# rows and 64-row Q / dO stages (up to 128 columns; wider, the
# backward's blocks hold 64 rows).

def _bf16_fwd_bwd(shape, causal, gen, seg=None):
    """bf16 forward and backward (twice, bitwise equal) against their
    plain versions on one seeded input."""
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    if seg is None:
        fwd = lambda: fa.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
    else:
        fwd = lambda: fa.flash_attention_seg_fwd(q, k, v, seg)
        o_ref, lse_ref = fa.flash_attention_seg_fwd_plain(q, k, v, seg)
    o, lse = fwd()
    if seg is None:
        bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    else:
        bwd = lambda: fa.flash_attention_seg_bwd(q, k, v, seg, o, lse, do)
        ref = fa.flash_attention_seg_bwd_plain(q, k, v, seg, o, lse, do)
    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    assert _row_rel(o, o_ref) <= BF16_ROW_TOL
    assert _rel(lse, lse_ref) <= F32_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if shape[1] == 1:
        # one token attends only to itself: dq and dk are exactly 0, and
        # the kernel's hold the float32 rounding of dP - delta.  A zero row
        # is held against the row check's floor, here 2^-10 of dv's
        # largest value (dq's and dk's are 0)
        floor = GRAD_ROW_FLOOR * float(ref[2].float().abs().max())
        for g in got[:2]:
            assert float(g.float().abs().max()) <= BF16_GRAD_ROW_TOL * floor
        got, ref = got[2:], ref[2:]
    _grads_close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("shape,causal", [
    ((2, 1, 128), True),         # one row
    ((3, 50, 128), True),        # less than one tile
    ((2, 127, 128), True),       # one short of a block
    ((2, 128, 128), True),       # exactly one block
    ((2, 129, 128), True),       # one past a block
    ((2, 193, 64), True),        # past a 64-row stage, d = 64
    ((2, 129, 128), False),      # non-causal, ragged
    ((1, 320, 64), False),       # non-causal, several stages
    ((2, 4096, 128), True),      # the main path's sequence length
])
def test_flash_kernels_at_tile_boundaries(cuda, shape, causal):
    _bf16_fwd_bwd(shape, causal, cuda)


@pytest.mark.parametrize("s,d", [(129, 128), (300, 64)])
def test_flash_seg_kernels_one_token_documents(cuda, s, d):
    """Segments of one token (each query sees only itself), a longer
    document, and a padding tail, through the segmented kernels."""
    seg = torch.zeros((2, s), dtype=torch.int64)
    ones = 37                               # one-token documents first
    seg[0, :ones] = torch.arange(1, ones + 1)
    seg[0, ones:s - 17] = ones + 1          # then one document, then padding
    seg[1, :s - 5] = torch.arange(1, s - 4)  # one token each, padding tail
    _bf16_fwd_bwd((4, s, d), True, cuda, seg.cuda())


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_seg_kernels_tile_aligned_documents(cuda, d):
    """Documents that cover whole tiles: tiles whose rows and keys share
    one segment skip the segment mask, and a tile whose keys all lie in
    an earlier document (one id, not the rows') stays masked.  Cuts at
    64-row boundaries that are not 128-row ones (192, 448) give the wide
    forward's 64-row stages uniform ids that differ from their 128-row
    block's."""
    seg = torch.zeros((2, 512), dtype=torch.int64)
    seg[0, :256], seg[0, 256:] = 1, 2
    seg[1, :128], seg[1, 128:428] = 5, 7
    if d > 128:
        seg[0, 192:256] = 3
        seg[1, 64:128], seg[1, 448:] = 6, 8
    _bf16_fwd_bwd((4, 512, d), True, cuda, seg.cuda())


@pytest.mark.parametrize("d,fwd_bf16,bwd_bf16", [
    (8, "wgmma", "wgmma"), (40, "wgmma", "wgmma"), (64, "wgmma", "wgmma"),
    (128, "wgmma", "wgmma"), (136, "wgmma", "wgmma"),
    (256, "wgmma", "wgmma"), (264, None, None)])
def test_flash_route_by_head_width(cuda, d, fwd_bf16, bwd_bf16):
    """Which kernel each head width takes: the bf16 forward and backward
    through wgmma at every width; float32 on the CUDA cores; no kernel
    above 256."""
    if fwd_bf16 is None:
        for backward in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                with pytest.raises(ValueError, match="no flash"):
                    fa.kernel_route(d, dtype, backward=backward)
        return
    assert fa.kernel_route(d, torch.bfloat16) == fwd_bf16
    assert fa.kernel_route(d, torch.float32) == "simt"
    assert fa.kernel_route(d, torch.bfloat16, backward=True) == bwd_bf16
    assert fa.kernel_route(d, torch.float32, backward=True) == "simt"


def test_flash_bwd_wgmma_at_every_bf16_head_width(cuda):
    """No bf16 backward reaches the CUDA-core kernels: every head width
    the kernels take, 8 to 256, goes through wgmma."""
    for d in range(8, 257, 8):
        assert fa.kernel_route(d, torch.bfloat16, backward=True) == "wgmma"


def test_flash_fwd_wgmma_at_every_bf16_head_width(cuda):
    """No bf16 forward reaches another kernel: every head width the
    kernels take, 8 to 256, goes through wgmma."""
    for d in range(8, 257, 8):
        assert fa.kernel_route(d, torch.bfloat16) == "wgmma"


# The bf16 kernels above 128 columns: the 192-column instances to 192,
# the 256-column ones above (d zero-filled to them).  The backward takes
# 64-row q- and k-tiles, the forward 128-row q-tiles; both stream two
# 64-row stages of a ring.  s 64 / 65 and 193 sit at a 64-row stage's
# edge and past one (at 193 the forward's last block has a stage that
# lies above its first consumer's rows).
@pytest.mark.parametrize("d", [136, 144, 192, 200, 256])
@pytest.mark.parametrize("s", [1, 64, 65, 127, 128, 129, 193, 4096])
@pytest.mark.parametrize("mode", ["causal", "dense", "segmented"])
def test_flash_wide_bwd_matches_plain(cuda, d, s, mode):
    """The wide bf16 backward and the forward before it against the
    plain versions at the existing tolerances, dense causal and not and
    segmented, from one row to the main path's sequence length; two runs
    of the backward bitwise equal."""
    assert fa.kernel_route(d, torch.bfloat16) == "wgmma"
    assert fa.kernel_route(d, torch.bfloat16, backward=True) == "wgmma"
    seg = None
    if mode == "segmented":
        seg = _segments(2, s, torch.Generator().manual_seed(s + d))
    _bf16_fwd_bwd((4 if seg is not None else 3, s, d), mode != "dense",
                  cuda, seg)


@pytest.mark.parametrize("d", [4, 12, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_functions_widen_odd_head_widths(cuda, d, dtype):
    """flash_attention and flash_attention_segmented at a head width off
    the multiples of 8 launch the kernels on zero-widened q, k, v: the
    output and the gradients have the true width and match the plain
    versions at it."""
    q, k, v, do = (torch.randn((4, 150, d), generator=cuda, device="cuda")
                   .to(dtype) for _ in range(4))
    seg = _segments(2, 150, torch.Generator().manual_seed(d))
    counts = lambda: (fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches,
                      fa.flash_attention_seg_fwd.launches,
                      fa.flash_attention_seg_bwd.launches)
    before = counts()
    for fn, plain_fwd, plain_bwd in (
            (lambda *t: fa.flash_attention(*t, True),
             lambda *t: fa.flash_attention_fwd_plain(*t, True),
             lambda q_, k_, v_, o, l: fa.flash_attention_bwd_plain(
                 q_, k_, v_, o, l, do, True)),
            (lambda *t: fa.flash_attention_segmented(*t, seg),
             lambda *t: fa.flash_attention_seg_fwd_plain(*t, seg),
             lambda q_, k_, v_, o, l: fa.flash_attention_seg_bwd_plain(
                 q_, k_, v_, seg, o, l, do))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        got = torch.autograd.grad(o, leaves, do)
        o_ref, lse_ref = plain_fwd(q, k, v)
        ref = plain_bwd(q, k, v, o_ref, lse_ref)
        torch.cuda.synchronize()
        assert o.shape == q.shape and all(g.shape == q.shape for g in got)
        if dtype == torch.float32:
            assert _rel(o, o_ref) <= F32_TOL
        else:
            assert _row_rel(o, o_ref) <= BF16_ROW_TOL
        _grads_close(got, ref, dtype)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)


_LN_DTYPES = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]
# both routes: registers to d = 4096, the stream route past it, up to
# the forward's MAX_D (14520: just past the widest row whose four
# float32 copies fit one block's shared memory; 14521 takes scalar
# loads); the LM's training shape once, in bf16
_LN_BWD_CASES = [
    (rows, d, xdt, gdt)
    for rows, d in [(1, 1), (5, 130), (300, 2048), (1000, 64), (1, 4096),
                    (37, 4096), (1, 14520), (37, 14520), (37, 14521),
                    (1, 16384), (37, 16384), (1, 43648), (37, 43648),
                    (37, ln.MAX_D)]
    for xdt, gdt in _LN_DTYPES] + [(16384, 2048, torch.bfloat16,
                                    torch.bfloat16)]


@pytest.mark.parametrize("rows,d,xdt,gdt", _LN_BWD_CASES)
@pytest.mark.parametrize("save_x", [False, True])
def test_layernorm_bwd_kernel_matches_plain(cuda, rows, d, xdt, gdt, save_x):
    x = (torch.randn((rows, d), generator=cuda, device="cuda") * 2 + 3)
    x = x.to(xdt)
    g = (torch.rand((d,), generator=cuda, device="cuda") + 0.5).to(gdt)
    g[d // 2] = 0.0
    b = torch.randn((d,), generator=cuda, device="cuda").to(gdt)
    dy = torch.randn((rows, d), generator=cuda, device="cuda").to(xdt)
    y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
    a = x if save_x else y
    assert ln.bwd_route(d) == ("register" if d <= ln.BWD_REG_MAX_D
                               else "stream")
    before = ln.layernorm_bwd.launches
    got = ln.layernorm_bwd(dy, a, g, b, mean, rstd, save_x)
    again = ln.layernorm_bwd(dy, a, g, b, mean, rstd, save_x)
    ref = ln.layernorm_bwd_plain(dy, a, g, b, mean, rstd, save_x)
    torch.cuda.synchronize()
    assert ln.layernorm_bwd.launches == before + 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert got[0].dtype == xdt and got[1].dtype == gdt
    if xdt == torch.float32:
        assert _rel(got[0], ref[0]) <= F32_TOL
    else:
        assert _row_rel(got[0], ref[0]) <= BF16_ROW_TOL
    vec_tol = F32_TOL if gdt == torch.float32 else 2.0 ** -7
    assert _rel(got[1], ref[1]) <= vec_tol and _rel(got[2], ref[2]) <= vec_tol


def test_layernorm_function_backward_through_the_kernel(cuda):
    x = torch.randn((64, 256), generator=cuda, device="cuda").requires_grad_()
    g = torch.ones((256,), device="cuda", requires_grad=True)
    b = torch.zeros((256,), device="cuda", requires_grad=True)
    before = (ln.layernorm_fwd.launches, ln.layernorm_bwd.launches)
    for save_x in (False, True):
        ln.layernorm(x, g, b, 1e-5, save_x).square().sum().backward()
    torch.cuda.synchronize()
    assert (ln.layernorm_fwd.launches - before[0],
            ln.layernorm_bwd.launches - before[1]) == (2, 2)


# ------------------------------------------------------------ CNN kernels

@pytest.mark.parametrize("shape,nsize,beta", [
    ((4, 96, 27, 27), 5, 0.75),   # AlexNet lrn1 (batch cut)
    ((2, 256, 13, 13), 5, 0.75),  # AlexNet lrn2
    ((3, 7, 5, 9), 4, 0.75),      # even window: transposed backward
    ((2, 16, 6, 6), 3, 0.6),      # pow path
    ((1, 3, 2, 2), 7, 0.75),      # window wider than the channels
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_kernels_match_plain(cuda, shape, nsize, beta, dtype):
    """LRN forward and backward against the plain versions (float32 at
    1e-4, bf16 per row at 2^-6); the backward twice, bitwise equal."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(dtype)
    g = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    args = (nsize, 0.01, beta, 1.0)
    before = (lrn.lrn_fwd.launches, lrn.lrn_bwd.launches)
    y = lrn.lrn_fwd(x, *args)
    dx, again = lrn.lrn_bwd(x, g, *args), lrn.lrn_bwd(x, g, *args)
    ref_y, ref_dx = lrn.lrn_fwd_plain(x, *args), lrn.lrn_bwd_plain(x, g,
                                                                    *args)
    torch.cuda.synchronize()
    assert (lrn.lrn_fwd.launches - before[0],
            lrn.lrn_bwd.launches - before[1]) == (1, 2)
    assert torch.equal(dx, again) and y.dtype == dx.dtype == dtype
    for got, ref in ((y, ref_y), (dx, ref_dx)):
        if dtype == torch.float32:
            assert _rel(got, ref) <= F32_TOL
        else:
            assert _row_rel(got, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("shape,geom", [
    ((4, 96, 55, 55), (3, 3, 2, 0, 0)),   # AlexNet pool1 (batch cut)
    ((2, 16, 13, 13), (3, 3, 2, 0, 0)),   # clipped tail
    ((2, 8, 12, 12), (2, 2, 2, 0, 0)),    # non-overlapping
    ((2, 8, 9, 10), (3, 2, 1, 1, 1)),     # padded, non-square
    ((3, 5, 14, 14), (3, 3, 2, 0, 0)),    # MNIST_CONV pool
    ((8, 96, 55, 55), (3, 3, 2, 0, 0)),   # AlexNet pool1, pool2, pool3
    ((8, 256, 27, 27), (3, 3, 2, 0, 0)),
    ((8, 256, 13, 13), (3, 3, 2, 0, 0)),
    ((3, 5, 55, 55), (3, 3, 2, 0, 0)),    # 15 planes: a ragged group
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_max_pool_kernels_match_plain_bitwise(cuda, shape, geom, dtype,
                                              relu):
    """Max pool forward and the all-ties backward (plain and relu-masked)
    against the plain versions, bitwise in both dtypes: both sum each
    input's windows in float32 in the same order.  The input has forced
    ties (values rounded to a coarse grid) and negatives."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2).round()
    x = (x / 2).to(dtype)
    before = (pool.max_pool_fwd.launches, pool.max_pool_bwd.launches)
    y = pool.max_pool_fwd(x, geom)
    dy = torch.randn(y.shape, generator=cuda, device="cuda").to(dtype)
    dx = pool.max_pool_bwd(x, y, dy, geom, relu)
    again = pool.max_pool_bwd(x, y, dy, geom, relu)
    torch.cuda.synchronize()
    assert (pool.max_pool_fwd.launches - before[0],
            pool.max_pool_bwd.launches - before[1]) == (1, 2)
    assert torch.equal(y, pool.max_pool_fwd_plain(x, geom))
    assert torch.equal(dx, again)
    assert torch.equal(dx, pool.max_pool_bwd_plain(x, y, dy, geom, relu))


@pytest.mark.parametrize("shape,geom,want", [
    ((4, 96, 55, 55), (3, 3, 2, 0, 0), "cells"),
    ((20, 97, 27, 27), (3, 3, 2, 0, 0), "cells"),  # a ragged last group
    ((2, 8, 9, 10), (3, 3, 1, 1, 1), "cells"),     # 3x3 at stride 1
    ((2, 8, 12, 13), (2, 2, 2, 1, 1), "cells"),
    ((2, 8, 9, 10), (3, 2, 1, 1, 1), "gather"),    # not square
    ((2, 8, 9, 10), (2, 2, 1, 1, 1), "gather"),    # 2x2 at stride 1
    ((2, 5, 55, 55), (5, 5, 3, 1, 1), "gather"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_max_pool_bwd_routes_match_plain_bitwise(cuda, shape, geom, want,
                                                 dtype, offset):
    """The backward's cells route (3x3 windows at stride 2 or 1, 2x2 at
    stride 2, any padding; x and dx 16-byte aligned) and gather route
    (other windows; tensors one element off 16-byte alignment),
    each twice and bitwise equal to the plain version, relu-masked and
    not."""
    x = _at_offset(((torch.randn(shape, generator=cuda, device="cuda") * 2)
                    .round() / 2).to(dtype), offset)
    y = _at_offset(pool.max_pool_fwd(x, geom), offset)
    dy = _at_offset(torch.randn(y.shape, generator=cuda, device="cuda")
                    .to(dtype), offset)
    assert pool.bwd_route(x, geom, offset == 0) == (
        want if offset == 0 else "gather")
    for relu in (False, True):
        dx = pool.max_pool_bwd(x, y, dy, geom, relu)
        again = pool.max_pool_bwd(x, y, dy, geom, relu)
        torch.cuda.synchronize()
        assert torch.equal(dx, again)
        assert torch.equal(dx, pool.max_pool_bwd_plain(x, y, dy, geom, relu))


@pytest.mark.parametrize("xshape,co,k,s,pad", [
    ((8, 3, 227, 227), 96, 11, 4, 0),   # AlexNet conv1 (batch cut)
    ((6, 1, 28, 28), 32, 3, 2, 1),      # MNIST_CONV conv1
    ((3, 5, 17, 19), 70, 4, 3, 2),      # ragged tiles, padding
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_wgrad_kernel_matches_plain(cuda, xshape, co, k, s, pad, dtype):
    """dW and db against the plain version from the same inputs, max
    |diff| / max |ref| within WGRAD_TOL (float32 sums of up to ~10^5
    terms in another order); twice, bitwise equal."""
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(xshape, generator=cuda, device="cuda").to(dtype)
    oh = (xshape[2] + 2 * pad - k) // s + 1
    ow = (xshape[3] + 2 * pad - k) // s + 1
    dy = torch.randn((xshape[0], co, oh, ow), generator=cuda,
                     device="cuda").to(dtype)
    before = cw.conv_wgrad_hwcn_pallas.launches
    got = cw.conv_wgrad_hwcn_pallas(x, dy, k, k, s, pad, pad)
    again = cw.conv_wgrad_hwcn_pallas(x, dy, k, k, s, pad, pad)
    ref = cw.conv_wgrad_plain(x, dy, k, k, s, pad, pad)
    torch.cuda.synchronize()
    assert cw.conv_wgrad_hwcn_pallas.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].shape == (co, xshape[1], k, k) and got[1].shape == (co,)
    assert _rel(got[0], ref[0]) <= WGRAD_TOL
    assert _rel(got[1], ref[1]) <= WGRAD_TOL


def test_cnn_functions_backward_through_the_kernels(cuda):
    """autograd through the LRN, pool (plain and relu-fused) and
    conv-bias Functions launches each kernel once."""
    from cxxnet_tpu_torch.ops.conv_wgrad import conv_bias_fast
    x = torch.randn((2, 3, 31, 31), generator=cuda, device="cuda")
    w = (torch.randn((8, 3, 7, 7), generator=cuda, device="cuda") * 0.1
         ).requires_grad_()
    b = torch.zeros((8,), device="cuda", requires_grad=True)
    counts = lambda: (lrn.lrn_fwd.launches, lrn.lrn_bwd.launches,
                      pool.max_pool_fwd.launches, pool.max_pool_bwd.launches,
                      cw.conv_wgrad_hwcn_pallas.launches)
    before = counts()
    h = conv_bias_fast(x, w, b, 3, 1, 1, "hwcn")
    h = pool.max_pool_relu_hwcn(h, 3, 3, 2)
    h = pool.max_pool_hwcn(lrn.lrn_pallas(h, 5, 1e-3, 0.75, 1.0), 2, 2, 1)
    h.square().sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (1, 1, 2, 2, 1)
    assert w.grad is not None and b.grad is not None


# ------------------------------------------------- fused adam, LRN (H, W,
# C, N), space-to-depth wgrad

def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _bf16_within_step(p, p_ref, w, w_ref):
    """Each bf16 param within one bf16 step (2^-7 of its magnitude) of
    the plain one, plus the masters' difference: both are roundings of
    masters that may differ by a few float32 ulps, which decides a param
    near zero."""
    p, p_ref = p.float(), p_ref.float()
    tol = torch.maximum(p.abs(), p_ref.abs()) * 2.0 ** -7 + (w - w_ref).abs()
    return bool((((p - p_ref).abs() <= tol) | (p.isnan() & p_ref.isnan()))
                .all())


@pytest.mark.parametrize("shape", [(16, 1024), (2048, 8192), (3, 8)])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.001, 0.5)])
def test_fused_adam_kernel_matches_plain(cuda, shape, wd, clip):
    """Three chained steps of the fused adam kernel against its plain
    version on the same inputs, with a NaN and an over-clip gradient:
    m1, m2 and the master within rtol 1e-5 (the kernel may contract
    multiply-adds into FMAs), the bf16 param the rounding of the
    kernel's own master and within one bf16 step of the plain one (plus
    the masters' difference, which decides a near-zero param); all
    written in place."""
    w = torch.randn(shape, generator=cuda, device="cuda") * 0.1
    state = [w.to(torch.bfloat16), torch.zeros_like(w), torch.zeros_like(w),
             w.clone()]
    ref = [t.clone() for t in state]
    before = fu.fused_adam_pallas.launches
    for step in range(3):
        g = (torch.randn(shape, generator=cuda, device="cuda") * 0.01
             ).to(torch.bfloat16)
        g.view(-1)[0], g.view(-1)[1] = float("nan"), 5.0
        args = (0.01 * (step + 1), 0.1, 0.001, wd, clip)
        p, m1, m2, w32 = state
        out = fu.fused_adam_pallas(g, m1, m2, w32, args[0], d1=args[1],
                                   d2=args[2], wd=wd, clip=clip, out=p)
        assert all(a is b for a, b in zip(out, state))
        ref = list(fu.fused_adam_plain(g, *ref[1:], *args))
        torch.cuda.synchronize()
        for got, want in zip(state[1:], ref[1:]):
            assert torch.isfinite(got).all() == bool(clip)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7,
                                       equal_nan=True)
        assert _same(state[0], state[3].to(torch.bfloat16))
        assert _bf16_within_step(state[0], ref[0], state[3], ref[3])
    assert fu.fused_adam_pallas.launches == before + 3


def test_fused_adam_rejects_what_it_does_not_take(cuda):
    buf = torch.zeros((8200,), device="cuda")
    g = torch.zeros((8200,), device="cuda", dtype=torch.bfloat16)
    p = g.clone()
    with pytest.raises(ValueError, match="aligned"):
        fu.fused_adam_pallas(g[1:8193], buf[1:8193], buf[1:8193],
                             buf[1:8193], 0.1, d1=0.1, d2=0.1,
                             out=p[1:8193])
    with pytest.raises(ValueError, match="float32"):
        fu.fused_adam_pallas(g, g, buf, buf, 0.1, d1=0.1, d2=0.1, out=p)
    with pytest.raises(ValueError, match="multiple of 8"):
        fu.fused_adam_pallas(g[:12], buf[:12], buf[:12], buf[:12], 0.1,
                             d1=0.1, d2=0.1, out=p[:12])


@pytest.mark.parametrize("shape,nsize,beta", [
    ((27, 27, 96, 128), 5, 0.75),   # AlexNet lrn1 (batch cut)
    ((13, 13, 256, 128), 5, 0.75),  # AlexNet lrn2 (batch cut)
    ((5, 9, 7, 3), 4, 0.75),        # even window, odd batch
    ((6, 6, 16, 2), 3, 0.6),        # pow path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_hwcn_kernels_match_plain(cuda, shape, nsize, beta, dtype):
    """The (H, W, C, N) LRN forward and backward against their plain
    versions (float32 at 1e-4, bf16 per row at 2^-6, rows along N); the
    backward twice, bitwise equal."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(dtype)
    g = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    args = (nsize, 0.01, beta, 1.0)
    before = (lrn.lrn_hwcn_fwd.launches, lrn.lrn_hwcn_bwd.launches)
    y = lrn.lrn_hwcn_fwd(x, *args)
    dx, again = lrn.lrn_hwcn_bwd(x, g, *args), lrn.lrn_hwcn_bwd(x, g, *args)
    ref_y = lrn.lrn_hwcn_fwd_plain(x, *args)
    ref_dx = lrn.lrn_hwcn_bwd_plain(x, g, *args)
    torch.cuda.synchronize()
    assert (lrn.lrn_hwcn_fwd.launches - before[0],
            lrn.lrn_hwcn_bwd.launches - before[1]) == (1, 2)
    assert torch.equal(dx, again) and y.dtype == dx.dtype == dtype
    for got, ref in ((y, ref_y), (dx, ref_dx)):
        if dtype == torch.float32:
            assert _rel(got, ref) <= F32_TOL
        else:
            assert _row_rel(got, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("xshape,co,k,s,pad", [
    ((8, 3, 227, 227), 96, 11, 4, 0),   # AlexNet conv1 (batch cut)
    ((6, 1, 28, 28), 32, 3, 2, 1),      # MNIST_CONV conv1
    ((3, 5, 17, 19), 70, 4, 3, 2),      # ragged tiles, padding, tail
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_wgrad_s2d_kernel_matches_plain(cuda, xshape, co, k, s, pad,
                                             dtype):
    """The space-to-depth wgrad against its plain version and against the
    strided conv's plain dW / db, within WGRAD_TOL; twice, bitwise
    equal."""
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(xshape, generator=cuda, device="cuda").to(dtype)
    oh = (xshape[2] + 2 * pad - k) // s + 1
    ow = (xshape[3] + 2 * pad - k) // s + 1
    dy = torch.randn((xshape[0], co, oh, ow), generator=cuda,
                     device="cuda").to(dtype)
    before = cw.conv_wgrad_s2d_pallas.launches
    got = cw.conv_wgrad_s2d_pallas(x, dy, k, k, s, pad, pad)
    again = cw.conv_wgrad_s2d_pallas(x, dy, k, k, s, pad, pad)
    torch.cuda.synchronize()
    assert cw.conv_wgrad_s2d_pallas.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].shape == (co, xshape[1], k, k) and got[1].shape == (co,)
    for ref in (cw.conv_wgrad_s2d_plain(x, dy, k, k, s, pad, pad),
                cw.conv_wgrad_plain(x, dy, k, k, s, pad, pad)):
        assert _rel(got[0], ref[0]) <= WGRAD_TOL
        assert _rel(got[1], ref[1]) <= WGRAD_TOL


def test_hwcn_lrn_s2d_wgrad_and_fused_adam_launch_their_kernels(cuda):
    """autograd through LRNHWCN and conv_bias_fast's ``pallas`` mode, and
    the adam updater under ``fused``, launch each new kernel."""
    from cxxnet_tpu_torch.ops.conv_wgrad import conv_bias_fast
    from cxxnet_tpu_torch.updater.updaters import (AdamUpdater,
                                                   UpdaterHyper)
    x = torch.randn((128, 3, 31, 31), generator=cuda, device="cuda")
    w = (torch.randn((8, 3, 7, 7), generator=cuda, device="cuda") * 0.1
         ).requires_grad_()
    b = torch.zeros((8,), device="cuda", requires_grad=True)
    counts = lambda: (lrn.lrn_hwcn_fwd.launches, lrn.lrn_hwcn_bwd.launches,
                      cw.conv_wgrad_s2d_pallas.launches,
                      fu.fused_adam_pallas.launches)
    before = counts()
    h = conv_bias_fast(x, w, b, 3, 1, 1, "pallas")
    lrn.lrn_pallas_hwcn(h, 5, 1e-3, 0.75, 1.0).square().sum().backward()
    p = torch.randn((8, 1024), generator=cuda, device="cuda").to(
        torch.bfloat16)
    up = AdamUpdater()
    st = up.make_state(p)
    up.apply(p, torch.ones_like(p), st, UpdaterHyper(), 0, fused=True)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (1, 1, 1, 1)
    assert torch.equal(p, st["w32"].to(torch.bfloat16))


# ------------------------------------------------------- routes (kernels)

def _ln_inputs(gen, rows, d, xdt, gdt, offset=0):
    """x (``offset`` elements into its buffer, so a nonzero offset leaves
    it misaligned for 16-byte loads), gamma, beta."""
    x = torch.empty((rows * d + offset,), dtype=xdt, device="cuda")[
        offset:].view(rows, d)
    x.copy_(torch.randn((rows, d), generator=gen, device="cuda") * 2 + 3)
    g = (torch.rand((d,), generator=gen, device="cuda") + 0.5).to(gdt)
    b = torch.randn((d,), generator=gen, device="cuda").to(gdt)
    return x, g, b


@pytest.mark.parametrize("rows", [1, 3, 4096])
@pytest.mark.parametrize("d", [8, 100, 2048, 2056, 4096, 4100, 20000])
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_layernorm_fwd_routes_match_plain(cuda, rows, d, xdt, gdt):
    """The layernorm forward at both routes (warp up to d = 4096, block
    past it) against the plain version, twice, bitwise equal."""
    x, g, b = _ln_inputs(cuda, rows, d, xdt, gdt)
    assert ln.kernel_route(d) == ("warp" if d <= ln.WARP_MAX_D else "block")
    y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
    again = ln.layernorm_fwd(x, g, b, 1e-5)
    y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip((y, mean, rstd), again))
    if xdt == torch.float32:
        assert _rel(y, y_ref) <= F32_TOL
    else:
        assert _row_rel(y, y_ref) <= BF16_ROW_TOL
    assert _rel(mean, m_ref) <= F32_TOL and _rel(rstd, r_ref) <= F32_TOL


@pytest.mark.parametrize("d", [8, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_fwd_warp_route_unaligned(cuda, d, dtype):
    """x and y one element off 16-byte alignment take the warp route's
    scalar loads; the same values as the plain version."""
    x, g, b = _ln_inputs(cuda, 33, d, dtype, dtype, offset=1)
    assert x.data_ptr() % 16 != 0
    y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
    y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, 1e-5)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert _rel(y, y_ref) <= F32_TOL
    else:
        assert _row_rel(y, y_ref) <= BF16_ROW_TOL
    assert _rel(mean, m_ref) <= F32_TOL and _rel(rstd, r_ref) <= F32_TOL


@pytest.mark.parametrize("d", [2048, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("save_x", [False, True])
def test_layernorm_bwd_routes_unaligned(cuda, d, dtype, save_x):
    """The residual and dy one element off 16-byte alignment take both
    backward routes' scalar loads; the same values as the plain version,
    twice, bitwise equal."""
    x, g, b = _ln_inputs(cuda, 33, d, dtype, dtype, offset=1)
    y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
    a = x if save_x else torch.empty((33 * d + 1,), dtype=dtype,
                                     device="cuda")[1:].view(33, d)
    if not save_x:
        a.copy_(y)
    dy = torch.empty((33 * d + 1,), dtype=dtype, device="cuda")[1:].view(
        33, d)
    dy.copy_(torch.randn((33, d), generator=cuda, device="cuda"))
    assert a.data_ptr() % 16 != 0 and dy.data_ptr() % 16 != 0
    got = ln.layernorm_bwd(dy, a, g, b, mean, rstd, save_x)
    again = ln.layernorm_bwd(dy, a, g, b, mean, rstd, save_x)
    ref = ln.layernorm_bwd_plain(dy, a, g, b, mean, rstd, save_x)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    if dtype == torch.float32:
        assert _rel(got[0], ref[0]) <= F32_TOL
    else:
        assert _row_rel(got[0], ref[0]) <= BF16_ROW_TOL
    vec_tol = F32_TOL if dtype == torch.float32 else 2.0 ** -7
    assert _rel(got[1], ref[1]) <= vec_tol and _rel(got[2], ref[2]) <= vec_tol


@pytest.mark.parametrize("xshape,co,k,s,pad", [
    ((8, 3, 227, 227), 96, 11, 4, 0),     # AlexNet conv1 (batch cut)
    ((256, 3, 227, 227), 96, 11, 4, 0),   # AlexNet conv1
    ((6, 1, 28, 28), 32, 3, 2, 1),        # MNIST_CONV conv1
    ((3, 5, 17, 19), 70, 4, 3, 2),        # ragged tiles, padding
    ((2, 4, 9, 9), 128, 3, 1, 1),         # co past the wgmma route
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_wgrad_routes_match_plain(cuda, xshape, co, k, s, pad, dtype):
    """Rows 5 and 6 at both routes (wgmma: bf16 with co <= 96; mma.sync:
    float32 and wider co): dW and db of conv_wgrad_hwcn_pallas and of
    conv_wgrad_s2d_pallas against conv_wgrad_plain and
    conv_wgrad_s2d_plain within WGRAD_TOL; each twice, bitwise equal,
    and the two wrappers bitwise equal (one kernel on the same x)."""
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(xshape, generator=cuda, device="cuda").to(dtype)
    oh = (xshape[2] + 2 * pad - k) // s + 1
    ow = (xshape[3] + 2 * pad - k) // s + 1
    dy = torch.randn((xshape[0], co, oh, ow), generator=cuda,
                     device="cuda").to(dtype)
    want = ("wgmma" if dtype == torch.bfloat16 and co <= 96
            else "mma.sync")
    assert cw.kernel_route(xshape[1], co, ow, k, k, s, dtype) == want
    args = (k, k, s, pad, pad)
    got = cw.conv_wgrad_hwcn_pallas(x, dy, *args)
    again = cw.conv_wgrad_hwcn_pallas(x, dy, *args)
    s2d = cw.conv_wgrad_s2d_pallas(x, dy, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, s2d))
    for ref in (cw.conv_wgrad_plain(x, dy, *args),
                cw.conv_wgrad_s2d_plain(x, dy, *args)):
        assert _rel(got[0], ref[0]) <= WGRAD_TOL
        assert _rel(got[1], ref[1]) <= WGRAD_TOL


@pytest.mark.parametrize("shape,nsize", [
    ((2, 40, 5, 6), 33), ((2, 40, 5, 6), 64), ((2, 40, 5, 6), 43),
    ((1, 920, 1, 3), 921),    # a ring wider than shared memory holds
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_bwd_kernels_at_wide_windows(cuda, shape, nsize, dtype):
    """lrn_bwd and lrn_hwcn_bwd launch their kernels at windows past 32
    channels (33, 64, C + 3, and one whose ring does not fit) and agree
    with the plain versions; twice, bitwise equal."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(dtype)
    g = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    args = (nsize, 0.01, 0.75, 1.0)
    xt = x.permute(lrn.TO_HWCN).contiguous()
    gt = g.permute(lrn.TO_HWCN).contiguous()
    before = (lrn.lrn_bwd.launches, lrn.lrn_hwcn_bwd.launches)
    runs = [(lrn.lrn_bwd(x, g, *args), lrn.lrn_bwd(x, g, *args),
             lrn.lrn_bwd_plain(x, g, *args)),
            (lrn.lrn_hwcn_bwd(xt, gt, *args), lrn.lrn_hwcn_bwd(xt, gt, *args),
             lrn.lrn_hwcn_bwd_plain(xt, gt, *args))]
    torch.cuda.synchronize()
    assert (lrn.lrn_bwd.launches - before[0],
            lrn.lrn_hwcn_bwd.launches - before[1]) == (2, 2)
    for dx, again, ref in runs:
        assert torch.equal(dx, again)
        if dtype == torch.float32:
            assert _rel(dx, ref) <= F32_TOL
        else:
            assert _row_rel(dx, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("layout,shape", [
    ("nchw", (4, 96, 27, 27)),     # AlexNet lrn1 (batch cut)
    ("nchw", (2, 256, 13, 13)),    # AlexNet lrn2 (batch cut)
    ("nchw", (256, 96, 27, 27)),   # lrn1 at its batch: C in one chunk
    ("hwcn", (27, 27, 96, 128)),   # lrn1 (batch cut): 16-byte pieces
    ("hwcn", (13, 13, 256, 128)),  # lrn2 (batch cut)
    ("hwcn", (5, 9, 7, 3)),        # images in no whole piece
])
@pytest.mark.parametrize("nsize", [3, 4, 5, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_lrn_bwd_window_route_matches_plain(cuda, layout, shape, nsize,
                                            dtype, offset):
    """The LRN backward's window route in both views (NCHW as (N, C,
    H*W), (H, W, C, N) as (H*W, C, N)) at the compiled windows, with x
    and g aligned ((H, W, C, N) in 16-byte pieces where N allows) or one
    element off (a column a thread): the plan, one launch a call, two
    runs bitwise equal, and the plain version's dx (float32 at 1e-4,
    bf16 per row at 2^-6)."""
    x = _at_offset((torch.randn(shape, generator=cuda, device="cuda") * 3
                    ).to(dtype), offset)
    g = _at_offset(torch.randn(shape, generator=cuda, device="cuda"
                               ).to(dtype), offset)
    args = (nsize, 0.01, 0.75, 1.0)
    if layout == "nchw":
        outer, c, inner = shape[0], shape[1], shape[2] * shape[3]
        run, plain = lrn.lrn_bwd, lrn.lrn_bwd_plain
        counter = lrn.lrn_bwd
    else:
        outer, c, inner = shape[0] * shape[1], shape[2], shape[3]
        run, plain = lrn.lrn_hwcn_bwd, lrn.lrn_hwcn_bwd_plain
        counter = lrn.lrn_hwcn_bwd
    v = 16 // x.element_size()
    plan = lrn.bwd_plan(outer, c, inner, nsize, x.element_size(),
                        aligned=offset == 0)
    assert plan.route == "window"
    assert plan.vec == (v if offset == 0 and inner % v == 0 else 1)
    before = counter.launches
    dx, again = run(x, g, *args), run(x, g, *args)
    ref = plain(x, g, *args)
    torch.cuda.synchronize()
    assert counter.launches - before == 2
    assert torch.equal(dx, again) and dx.dtype == dtype
    if dtype == torch.float32:
        assert _rel(dx, ref) <= F32_TOL
    else:
        assert _row_rel(dx, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("layout,shape", [
    ("nchw", (256, 96, 27, 27)),   # AlexNet lrn1: C in one chunk
    ("nchw", (256, 256, 13, 13)),  # lrn2: C in chunks
    ("hwcn", (27, 27, 96, 256)),   # lrn1: 16-byte pieces, C in chunks
    ("hwcn", (13, 13, 256, 128)),  # lrn2 (batch cut)
    ("hwcn", (5, 9, 7, 3)),        # images in no whole piece
])
@pytest.mark.parametrize("nsize", [3, 4, 5, 7, 9, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_lrn_fwd_routes_match_plain(cuda, layout, shape, nsize, dtype,
                                    offset):
    """The LRN forward in both views at AlexNet's layers: the window route
    at the compiled windows (16-byte pieces of images where N and the
    alignment allow, else a column a thread) and the recompute route at
    9 and 33; x aligned or one element off.  The plan, one launch a
    call, two runs bitwise equal, and the plain version's y (float32 at
    1e-4, bf16 per row at 2^-6)."""
    x = _at_offset((torch.randn(shape, generator=cuda, device="cuda") * 3
                    ).to(dtype), offset)
    args = (nsize, 0.01, 0.75, 1.0)
    if layout == "nchw":
        outer, c, inner = shape[0], shape[1], shape[2] * shape[3]
        run, plain = lrn.lrn_fwd, lrn.lrn_fwd_plain
    else:
        outer, c, inner = shape[0] * shape[1], shape[2], shape[3]
        run, plain = lrn.lrn_hwcn_fwd, lrn.lrn_hwcn_fwd_plain
    v = 16 // x.element_size()
    plan = lrn.fwd_plan(outer, c, inner, nsize, x.element_size(),
                        aligned=offset == 0)
    if nsize in lrn.WINDOW_SIZES:
        assert plan.route == "window"
        assert plan.vec == (v if offset == 0 and inner % v == 0 else 1)
    else:
        assert plan.route == "recompute"
    before = run.launches
    y, again = run(x, *args), run(x, *args)
    ref = plain(x, *args)
    torch.cuda.synchronize()
    assert run.launches - before == 2
    assert torch.equal(y, again) and y.dtype == dtype
    if dtype == torch.float32:
        assert _rel(y, ref) <= F32_TOL
    else:
        assert _row_rel(y, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("shape,geom,want", [
    ((4, 96, 55, 55), (3, 3, 2, 0, 0), "cells"),     # AlexNet pool1
    ((20, 97, 27, 27), (3, 3, 2, 0, 0), "cells"),    # a ragged last group
    ((8, 256, 13, 13), (3, 3, 2, 0, 0), "cells"),    # AlexNet pool3
    ((3, 32, 14, 14), (3, 3, 2, 0, 0), "cells"),     # MNIST_CONV
    ((2, 8, 28, 28), (3, 3, 2, 1, 1), "cells"),      # padded
    ((2, 8, 9, 10), (3, 3, 1, 1, 1), "cells"),       # 3x3 at stride 1
    ((2, 8, 12, 13), (2, 2, 2, 1, 1), "cells"),
    ((2, 8, 9, 10), (3, 2, 1, 1, 1), "per-output"),  # not square
    ((2, 5, 55, 55), (5, 5, 3, 1, 1), "per-output"),
    ((1, 2, 300, 300), (3, 3, 2, 0, 0), "per-output"),  # past the budget
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_max_pool_fwd_routes_match_plain_bitwise(cuda, shape, geom, want,
                                                 dtype, offset):
    """The max-pool forward's cells route (the backward's cells windows,
    any padding; x and y 16-byte aligned) and per-output route (other
    windows, large planes, x one element off alignment): one launch a
    call, bitwise equal to the plain version, on inputs with ties and
    negatives."""
    x = _at_offset(((torch.randn(shape, generator=cuda, device="cuda") * 2)
                    .round() / 2 - 0.5).to(dtype), offset)
    assert pool.fwd_route(x, geom, offset == 0) == (
        want if offset == 0 else "per-output")
    before = pool.max_pool_fwd.launches
    y, again = pool.max_pool_fwd(x, geom), pool.max_pool_fwd(x, geom)
    torch.cuda.synchronize()
    assert pool.max_pool_fwd.launches - before == 2
    assert torch.equal(y, again)
    assert torch.equal(y, pool.max_pool_fwd_plain(x, geom))


@pytest.mark.parametrize("dim,nhead,dense", [(256, 1, 0), (128, 1, 0),
                                             (24, 2, 0), (264, 1, 1)])
def test_lm_step_routes_attention_by_head_width(cuda, tmp_path, dim, nhead,
                                                dense):
    """One training step of a depth-1 bf16 packed LM: at head widths 256
    (the wide wgmma backward), 128 (wgmma) and 12 (widened to 16) the
    segmented flash kernels run forward and backward once, and at 264,
    above every kernel, the attention takes the dense route once and
    runs no flash kernel; the loss is finite either way."""
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.layers import sequence as tseq
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    gen = torch.Generator().manual_seed(3)
    write_token_shard(str(tmp_path / "c.tok"),
                      [torch.randint(0, 64, (int(n),), generator=gen).numpy()
                       for n in torch.randint(20, 200, (12,),
                                              generator=gen)],
                      itemsize=2)
    it = init_iterator(create_iterator(
        [("iter", "text"), ("path_tok", str(tmp_path / "c.tok")),
         ("iter", "packseq"), ("seqlen", "256"), ("iter", "end")]),
        [("batch_size", "2"), ("silent", "1")])
    it.before_first()
    batch = it.next()
    tr = NetTrainer()
    for k, v in parse_config_string(transformer(
            vocab=64, seq=256, dim=dim, nlayer=1, nhead=nhead, packed=True)):
        tr.set_param(k, v)
    for k, v in (("batch_size", "2"), ("dev", "gpu"), ("dtype", "bfloat16"),
                 ("updater", "adam"), ("eta", "1e-3"), ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    counts = lambda: (tseq.single_device_attention.dense_routes,
                      fa.flash_attention_seg_fwd.launches,
                      fa.flash_attention_seg_bwd.launches)
    before = counts()
    tr.update(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(float(tr.last_loss)))
    flash = 1 - dense
    assert tuple(a - b for a, b in zip(counts(), before)) == (dense, flash,
                                                              flash)


def test_ckpt_continue_on_the_card_is_bitwise(cuda, tmp_path):
    """A bf16 packed LM (d 128, one head of 128, s 256) under fused adam
    trains 3 rounds with ckpt_async = 1 (run A); run B stops after round
    2 and a fresh task continues it (continue = 1) to round 3: both
    0003.ckpt hold the same arrays bitwise, the same train_state (the
    CUDA generator's state included) and iterator state, and the fused
    adam kernel and the segmented flash kernels ran in the continued
    round."""
    from cxxnet_tpu_torch import ckpt
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.models import transformer
    gen = torch.Generator().manual_seed(5)
    write_token_shard(str(tmp_path / "c.tok"),
                      [torch.randint(0, 64, (int(n),), generator=gen).numpy()
                       for n in torch.randint(20, 300, (30,),
                                              generator=gen)],
                      itemsize=2)
    net = transformer(vocab=64, seq=256, dim=128, nlayer=1, nhead=1,
                      packed=True)

    def run(name, *args):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(
            f"dev = gpu\ntask = train\nmodel_dir = {tmp_path}/{name}\n"
            f"data = train\niter = text\n  path_tok = {tmp_path}/c.tok\n"
            "iter = packseq\n  seqlen = 256\niter = end\n"
            f"{net}\nbatch_size = 2\ndtype = bfloat16\nupdater = adam\n"
            "eta = 1e-3\nfused_update = 1\nnum_round = 3\nsave_model = 1\n"
            "ckpt_async = 1\nckpt_keep = 1\neval_train = 0\nsilent = 1\n")
        task = LearnTask()
        assert task.run([str(conf), *args]) == 0
        return task

    run("A")
    run("B", "num_round=2")
    before = (fu.fused_adam_pallas.launches,
              fa.flash_attention_seg_fwd.launches,
              fa.flash_attention_seg_bwd.launches)
    resumed = run("B", "continue=1")
    steps = resumed.last_train["steps"]
    assert steps > 0
    after = (fu.fused_adam_pallas.launches,
             fa.flash_attention_seg_fwd.launches,
             fa.flash_attention_seg_bwd.launches)
    assert all(a - b >= steps for a, b in zip(after, before))
    ma, sa = ckpt.load_snapshot(str(tmp_path / "A" / "0003.ckpt"))
    mb, sb = ckpt.load_snapshot(str(tmp_path / "B" / "0003.ckpt"))
    assert sa.keys() == sb.keys()
    for shard in sa:
        assert sa[shard].keys() == sb[shard].keys()
        for k, v in sa[shard].items():
            assert v.tobytes() == sb[shard][k].tobytes(), f"{shard}:{k}"
    for key in ("train_state", "iter_state"):
        assert ma["extra"][key] == mb["extra"][key]
    assert "torch_rng_state" in ma["extra"]["train_state"]


def _bf16_lm(vocab, seq, dim, nlayer, nhead, slots):
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    tr = NetTrainer()
    for k, v in parse_config_string(transformer(vocab=vocab, seq=seq,
                                                dim=dim, nlayer=nlayer,
                                                nhead=nhead)):
        tr.set_param(k, v)
    for k, v in (("batch_size", str(slots)), ("dtype", "bfloat16"),
                 ("dev", "gpu"), ("seed", "3"), ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    return tr


def test_decode_block_against_steps_on_the_card(cuda):
    """A bf16 LM (d 128, 2 heads of 64, depth 2, s 256, 2 slots) with
    block widths 4 and 16: one width-4 block against four sequential
    steps, and a chunked prefill (C 16) of a 100-token prompt against
    the whole prefill, within the serving envelope (SERVE_TOL bf16);
    every forward ran the layernorm kernel (2 * depth + 1 launches) and
    each whole prefill the flash forward (one a layer)."""
    import numpy as np
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    from cxxnet_tpu_torch.serve.engine import SERVE_TOL
    eng = DecodeEngine(_bf16_lm(256, 256, 128, 2, 2, 2), slots=2,
                       block_widths=(4, 16))
    eng.warmup()
    ln0, fa0 = ln.layernorm_fwd.launches, fa.flash_attention_fwd.launches
    prompt = np.random.RandomState(1).randint(0, 256, 100).astype(np.int32)
    toks = [int(np.argmax(eng.prefill(1, prompt)))]
    rows = []
    for i in range(4):
        step = eng.step(np.asarray([0, toks[-1]], np.int32),
                        np.asarray([0, 100 + i], np.int32))
        rows.append(step[1])
        toks.append(int(np.argmax(step[1])))
    blk = eng.block(np.asarray([[0] * 4, toks[:4]], np.int32),
                    np.asarray([0, 100], np.int32))
    tol = SERVE_TOL["bf16"]
    for i in range(4):
        assert _rel(torch.from_numpy(blk[1, i]),
                    torch.from_numpy(rows[i])) <= tol, i
    whole = eng.prefill(0, prompt)
    for off in range(0, 100, 16):
        tokens = np.zeros((2, 16), np.int32)
        tokens[0, :len(prompt[off:off + 16])] = prompt[off:off + 16]
        chunk = eng.block(tokens, np.asarray([off, 0], np.int32))
    assert _rel(torch.from_numpy(chunk[0, 99 - 96]),
                torch.from_numpy(whole)) <= tol
    forwards = 2 + 4 + 1 + 7
    assert ln.layernorm_fwd.launches - ln0 >= 5 * forwards
    assert fa.flash_attention_fwd.launches - fa0 >= 2 * 2
    assert eng.retraces == 0 and eng.block_calls == 8


def test_int8_predict_engine_on_the_card(cuda):
    """An int8 PredictEngine of a conv / pool / fullc net under
    pool_layout = hwcn on the card: the int8 weights and their scales
    live on the device, one dispatch per bucket goes through the max-pool
    kernel, and the rows are within SERVE_TOL int8 of the f32 engine's."""
    import numpy as np
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve.engine import SERVE_TOL, PredictEngine
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = ("netconfig=start\nlayer[0->1] = conv:cv1\n  kernel_size = 3\n"
           "  pad = 1\n  stride = 2\n  nchannel = 16\n"
           "layer[1->2] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
           "layer[2->3] = flatten\nlayer[3->4] = fullc:fc1\n"
           "  nhidden = 32\nlayer[4->5] = sigmoid\n"
           "layer[5->6] = fullc:fc2\n  nhidden = 10\n"
           "layer[6->6] = softmax\nnetconfig=end\ninput_shape = 1,28,28\n")
    tr = NetTrainer()
    for k, v in parse_config_string(net):
        tr.set_param(k, v)
    for k, v in (("batch_size", "32"), ("dev", "gpu"),
                 ("pool_layout", "hwcn"), ("random_type", "xavier"),
                 ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    f32 = PredictEngine(tr, shapes=(1, 8, 32), dtype="f32")
    q8 = PredictEngine(tr, shapes=(1, 8, 32), dtype="int8")
    f32.warmup()
    q8.warmup()
    for key in q8._quant_keys():
        assert q8._params[key]["wmat"].dtype == torch.int8
        assert q8._params[key]["wmat"].is_cuda
        assert q8._scales[key]["wmat"].is_cuda
    x = np.random.RandomState(2).rand(45, 1, 28, 28).astype(np.float32)
    before = pool.max_pool_fwd.launches
    got = q8.predict(x)
    assert pool.max_pool_fwd.launches - before == 2     # 32 + 13 -> 32
    assert got.shape == (45, 10)
    assert q8.retraces == 0 and q8.stats()["bucket_hist"] == {"32": 2}
    assert _rel(torch.from_numpy(got),
                torch.from_numpy(f32.predict(x))) <= SERVE_TOL["int8"]
    assert q8.pairtest(x[:8]) <= SERVE_TOL["int8"]


# ------------------------------------------ GoogLeNet's shapes, the pool
# gate on the card

@pytest.mark.parametrize("shape", [(128, 64, 56, 56), (128, 192, 56, 56)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_kernels_at_googlenet_shapes(cuda, shape, dtype):
    """GoogLeNet's two LRNs (local_size 5, a batch_split chain of 128
    images) against the plain versions: float32 at 1e-4, bf16 per row at
    2^-6; the backward twice, bitwise equal."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(dtype)
    g = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    args = (5, 1e-4, 0.75, 1.0)
    y, dx = lrn.lrn_fwd(x, *args), lrn.lrn_bwd(x, g, *args)
    assert torch.equal(dx, lrn.lrn_bwd(x, g, *args))
    for got, ref in ((y, lrn.lrn_fwd_plain(x, *args)),
                     (dx, lrn.lrn_bwd_plain(x, g, *args))):
        if dtype == torch.float32:
            assert _rel(got, ref) <= F32_TOL
        else:
            assert _row_rel(got, ref) <= BF16_ROW_TOL


@pytest.mark.parametrize("shape,geom", [
    ((128, 64, 112, 112), (3, 3, 2, 0, 0)),   # pool1
    ((128, 192, 56, 56), (3, 3, 2, 0, 0)),    # pool2
    ((128, 192, 28, 28), (3, 3, 1, 1, 1)),    # i3a's inception pool
    ((128, 64, 28, 28), (3, 3, 1, 1, 1)),     # a segment of i3a_out
    ((128, 96, 28, 28), (3, 3, 2, 0, 0)),     # pool3 on a segment
    ((128, 320, 14, 14), (3, 3, 1, 1, 1)),    # i4 pools on segments
    ((128, 128, 14, 14), (3, 3, 2, 0, 0)),    # pool4 on a segment
    ((128, 384, 7, 7), (3, 3, 1, 1, 1)),      # i5b's pool on a segment
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_kernels_at_googlenet_shapes(cuda, shape, geom, dtype):
    """GoogLeNet's pools (a batch_split chain of 128 images) on relu'd
    inputs on a grid, so whole windows tie at zero and above: forward
    and the all-ties backward, plain and relu-masked, bitwise equal to
    the plain versions, each backward twice."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2).round()
    x = torch.relu(x / 2).to(dtype)
    y = pool.max_pool_fwd(x, geom)
    assert torch.equal(y, pool.max_pool_fwd_plain(x, geom))
    dy = ((torch.randn(y.shape, generator=cuda, device="cuda") * 8).round()
          / 8).to(dtype)
    for relu in (False, True):
        dx = pool.max_pool_bwd(x, y, dy, geom, relu)
        torch.cuda.synchronize()
        assert torch.equal(dx, pool.max_pool_bwd(x, y, dy, geom, relu))
        assert torch.equal(dx, pool.max_pool_bwd_plain(x, y, dy, geom,
                                                       relu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_wgrad_kernel_at_googlenet_conv1(cuda, dtype):
    """GoogLeNet's conv1 (x (128, 3, 224, 224), 7x7 stride 2 pad 3 to 64
    channels) dW and db against the plain version within WGRAD_TOL;
    twice, bitwise equal; on the mma.sync split-K route in both dtypes
    (the wgmma route takes output rows of at most 64, and conv1's are
    112 wide)."""
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand((128, 3, 224, 224), generator=cuda,
                   device="cuda").to(dtype)
    dy = torch.randn((128, 64, 112, 112), generator=cuda,
                     device="cuda").to(dtype)
    got = cw.conv_wgrad_hwcn_pallas(x, dy, 7, 7, 2, 3, 3)
    again = cw.conv_wgrad_hwcn_pallas(x, dy, 7, 7, 2, 3, 3)
    ref = cw.conv_wgrad_plain(x, dy, 7, 7, 2, 3, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(got[0], ref[0]) <= WGRAD_TOL
    assert _rel(got[1], ref[1]) <= WGRAD_TOL
    assert cw.kernel_route(3, 64, 112, 7, 7, 2, dtype) == "mma.sync"


@pytest.mark.parametrize("batch,fused", [(128, 1), (64, 0), (130, 0)])
def test_relu_pool_gate_on_the_card(cuda, batch, fused):
    """``pool_relu_fuse = 1`` under ``pool_layout = nchw pool_bwd = sas``
    on the card: a deferred-relu pool (k3 s2, no padding) fuses into the
    relu-masked all-ties kernels only at a batch of whole 128-image
    tiles, as the JAX package's gate admits it on the TPU; elsewhere it
    launches no kernel (the one-winner pool, then relu)."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.ops import nn as N
    opts = EngineOptions()
    opts.set("pool_relu_fuse", "1")
    x = torch.randn((batch, 16, 27, 27), generator=cuda,
                    device="cuda").requires_grad_()
    before = (pool.max_pool_fwd.launches, pool.max_pool_bwd.relu_launches)
    N.max_pool2d_relu(x, 3, 3, 2, opts=opts).sum().backward()
    torch.cuda.synchronize()
    assert (pool.max_pool_fwd.launches - before[0],
            pool.max_pool_bwd.relu_launches - before[1]) == (fused, fused)


# ------------------------------------------------------- staged batches

def _alexnet_like_trainer(extra=""):
    """A small conv net's trainer on the card with AlexNet's input
    normalisation keys (no kernel key: the staging is what is held)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(f"""netconfig=start
layer[0->1] = conv
  kernel_size = 11
  stride = 4
  nchannel = 8
layer[1->2] = flatten
layer[2->3] = fullc
  nhidden = 10
layer[3->3] = softmax
netconfig=end
input_shape = 3,67,67
batch_size = 64
dev = gpu
dtype = bfloat16
mean_value = 123.68,116.78,103.94
scale = 0.017
silent = 1
{extra}"""):
        t.set_param(k, v)
    t.init_model()
    return t


def _u8_batches(n, seed=0, shape=(64, 3, 67, 67)):
    from cxxnet_tpu_torch.io.data import DataBatch
    rnd = np.random.RandomState(seed)
    return [DataBatch(rnd.randint(0, 256, shape).astype(np.uint8),
                      rnd.randint(0, 10, (shape[0], 1)).astype(np.float32),
                      np.arange(shape[0], dtype=np.uint32),
                      num_batch_padd=i % 2, tail_mask_padd=i % 2)
            for i in range(n)]


class _List:
    def __init__(self, items):
        self.items = items

    def before_first(self):
        self.i = 0

    def next(self):
        if self.i >= len(self.items):
            return None
        self.i += 1
        return self.items[self.i - 1]


@pytest.mark.parametrize("s2d", [0, 1])
def test_u8_normalisation_on_the_card_matches_cpu(cuda, s2d):
    """A staged u8 batch normalised on the card equals the CPU's
    normalisation bitwise (float32 subtract and multiply), plain and in
    the ``input_s2d`` staged form."""
    t = _alexnet_like_trainer(f"input_s2d = {s2d}")
    [b] = _u8_batches(1)
    sb = t.stage_batch(b)
    assert sb.data.is_cuda and sb.ready is not None
    got = t._normalize_input(sb.handover().data).cpu()
    t.device = torch.device("cpu")
    want = t._normalize_input(t.stage_batch(b).data)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def _busy(n=6):
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(n):
        a = a @ a
        a = a / a.abs().amax().clamp_min(1.0)
    return a


@pytest.mark.parametrize("depth", [2, 0])
def test_prefetcher_race_against_a_busy_stream(cuda, depth):
    """Batches staged on the copy stream while bf16 matmuls keep the
    compute stream busy, each normalised there and then dropped: every
    result equals the CPU's bitwise (a staged tensor recycled under the
    step, or read before its copy ended, would differ)."""
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    t = _alexnet_like_trainer()
    batches = _u8_batches(8, seed=1)
    pf = DevicePrefetcher(_List(batches), t, depth=depth)
    outs = []
    try:
        for [sb] in pf:
            _busy()
            sb.handover()
            outs.append(t._normalize_input(sb.data))
            del sb
            torch.empty(64 * 3 * 67 * 67, dtype=torch.uint8,
                        device="cuda").fill_(7)
    finally:
        pf.close()
    torch.cuda.synchronize()
    cpu = _alexnet_like_trainer()
    cpu.device = torch.device("cpu")
    assert len(outs) == len(batches)
    for b, got in zip(batches, outs):
        want = cpu._normalize_input(torch.from_numpy(b.data))
        assert torch.equal(got.cpu(), want)


def test_prefetcher_race_against_an_idle_stream(cuda):
    """u8 batches at AlexNet's shape (a copy of milliseconds) read on an
    idle compute stream the moment the depth-2 prefetcher hands them
    over, while their copies may still be in flight: every result equals
    the CPU's bitwise (a read that did not wait on the batch's event
    would see a partly copied batch)."""
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    t = _alexnet_like_trainer()
    batches = _u8_batches(6, seed=4, shape=(256, 3, 227, 227))
    pf = DevicePrefetcher(_List(batches), t, depth=2)
    outs = []
    try:
        for [sb] in pf:
            sb.handover()
            outs.append(t._normalize_input(sb.data))
            del sb
    finally:
        pf.close()
    cpu = _alexnet_like_trainer()
    cpu.device = torch.device("cpu")
    assert len(outs) == len(batches)
    for b, got in zip(batches, outs):
        want = cpu._normalize_input(torch.from_numpy(b.data))
        assert torch.equal(got.cpu(), want)


def test_record_stream_keeps_a_freed_staged_batch(cuda):
    """A staged batch freed while the step that reads it is still queued
    behind a busy stream: ``handover``'s ``record_stream`` keeps its
    block from the copy stream's next allocation, which is filled at
    once; the step still reads the batch's values."""
    t = _alexnet_like_trainer()
    [b] = _u8_batches(1, seed=2)
    copy = torch.cuda.Stream()
    with torch.cuda.stream(copy):
        sb = t.stage_batch(b)
    _busy(12)
    sb.handover()
    total = sb.data.to(torch.int64).sum()
    del sb
    with torch.cuda.stream(copy):
        for _ in range(4):
            torch.empty(b.data.size, dtype=torch.uint8,
                        device="cuda").fill_(255)
    assert int(total) == int(b.data.astype(np.int64).sum())


def test_staged_steps_equal_host_steps_on_the_card(cuda):
    """Training from prefetched staged batches (depth 2) equals training
    from the host batches bitwise on the card."""
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    a, b = _alexnet_like_trainer(), _alexnet_like_trainer()
    batches = _u8_batches(4, seed=3)
    for x in batches:
        a.update(x)
    pf = DevicePrefetcher(_List(batches), b, depth=2)
    try:
        for item in pf:
            for sb in item:
                b.update(sb)
    finally:
        pf.close()
    for k, g in a.params.items():
        for tag, v in g.items():
            assert torch.equal(v, b.params[k][tag]), f"{k}/{tag}"


# ------------------------------------------------ profile window, on the card

def _lm_window(tmp_path):
    """A small packed LM (bf16, flash_attn = 1, pallas_ln = 1, adam,
    fused_update = 1) on the card: one warm-up step, then one step inside
    a ProfileWindow.  Returns (trainer, window, trace events)."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.monitor import trace
    from cxxnet_tpu_torch.monitor.trace import ProfileWindow
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    s = 128
    t = NetTrainer()
    for k, v in parse_config_string(transformer(
            vocab=64, seq=s, dim=128, nlayer=2, nhead=2, packed=True)) + [
            ("batch_size", "2"), ("dev", "gpu"), ("dtype", "bfloat16"),
            ("updater", "adam"), ("eta", "0.001"), ("flash_attn", "1"),
            ("pallas_ln", "1"), ("fused_update", "1"), ("eval_train", "0"),
            ("silent", "1")]:
        t.set_param(k, v)
    t.init_model()
    rnd = np.random.RandomState(0)
    ids = rnd.randint(0, 64, (2, s)).astype(np.float32)
    seg = np.ones((2, s), np.float32)
    pos = np.tile(np.arange(s, dtype=np.float32), (2, 1))
    batch = DataBatch(data=ids.reshape(2, 1, 1, s),
                      label=np.concatenate([np.roll(ids, -1, 1), seg, pos], 1),
                      index=np.arange(2, dtype=np.uint32))
    t.update(batch)
    t.sync()
    win = ProfileWindow(str(tmp_path / "prof"), start_step=0, num_steps=1,
                        net=t.net, device=t.device)
    win.maybe_start_step(0)
    t.update(batch)
    t.sync()
    assert win.after_step()
    return t, win, trace.load_trace(win.last_trace)


def test_trace_reader_on_cuda_events(cuda, tmp_path):
    """The Chrome-trace reader's device time of a window equals the
    union of the profiler's own device events of the same window within
    5%, each hand-written kernel's events cover its launches, and one
    card has no collective."""
    from torch.autograd import DeviceType
    from cxxnet_tpu_torch.monitor import trace
    _, win, events = _lm_window(tmp_path)
    rep = trace.comm_report_in(events, steps=1)
    own = [(e.time_range.start, e.time_range.end)
           for e in win.last_profiler.events()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    own_sec = trace.union_us(own) / 1e6
    assert rep["device_sec"] > 0
    assert abs(rep["device_sec"] - own_sec) <= 0.05 * own_sec, (rep, own_sec)
    assert rep["comm_sec"] == 0 and rep["comm_by_kind"] == {}
    assert sum(win.last_launches.values()) > 0
    assert trace.kernel_shortfall(events, win.last_launches) == {}


def test_backward_attribution_across_the_autograd_thread(cuda, tmp_path):
    """On the card the backward kernels launch from the autograd
    engine's thread, outside every connection range: the flash backward
    books to its attention connection and the layernorm backward to its
    layernorm connection through the sequence-number join, the forward
    kernels to the same connections directly, and the fused adam kernel
    to (unattributed)."""
    from cxxnet_tpu_torch.monitor import attribution, trace
    t, _, events = _lm_window(tmp_path)
    placed = attribution.attribute_events(events, t.layer_scopes())
    launch_tid = {(e.get("args") or {}).get("correlation"): e.get("tid")
                  for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")}
    by = {}
    for p, e in zip(placed, [e for e in events
                             if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")]):
        by.setdefault(trace.kernel_base(p["name"]), []).append(
            (p, launch_tid.get((e.get("args") or {}).get("correlation"))))

    def check(prefix, scope_part, backward):
        hits = [(p, tid) for name, ps in by.items() if name.startswith(prefix)
                for p, tid in ps]
        assert hits, (prefix, sorted(by))
        for p, _ in hits:
            assert p["scope"] is not None and scope_part in p["scope"], p
            assert p["backward"] == backward, p
        return {tid for _, tid in hits}

    fwd_tids = check("flash_fwd", "_att", False)
    bwd_tids = check("flash_bwd", "_att", True)
    assert not fwd_tids & bwd_tids
    check("layernorm_fwd", "_ln", False)
    check("lnb_", "_ln", True)
    for p, _ in by["fused_adam_kernel"]:
        assert p["scope"] is None
    table = attribution.layer_table(events, t.layer_scopes())
    att = [r for r in table["rows"] if r["layer"].endswith("_att")]
    assert att and all(0 < r["bwd_ms"] < r["device_ms"] for r in att)


@pytest.mark.parametrize("remat", ["0", "2"])
def test_mem_probe_reads_the_allocator_on_the_card(cuda, remat):
    """One update step of a small MLP on the card through the allocator
    probe (``NetTrainer.arm_mem_probe``): a reading before the step,
    after each connection's forward (once, under ``remat`` too), after
    the backward and after the update; each forward leaves its output
    live; the peak holds every reading; the gauges keep the process's
    high-water across the probe's reset; the card's tables resolve
    (``costmodel``)."""
    from cxxnet_tpu_torch.analysis import costmodel, memmodel
    from cxxnet_tpu_torch.monitor import memory
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = ("netconfig=start\nlayer[+1] = fullc:fc1\n  nhidden = 1024\n"
           "layer[+1] = relu\nlayer[+1] = fullc:fc2\n  nhidden = 16\n"
           "layer[+0] = softmax\nnetconfig=end\ninput_shape = 1,1,512\n"
           "batch_size = 256\nupdater = adam\ndev = gpu\nsilent = 1\n"
           f"remat = {remat}\n")
    t = NetTrainer()
    for k, v in parse_config_string(net):
        t.set_param(k, v)
    t.init_model()
    x = torch.rand(256, 1, 1, 512, device="cuda")
    lab = torch.randint(0, 16, (256, 1), device="cuda").float()
    t.update_step({0: x}, t.label_info(lab))        # optimizer state made
    big = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    del big                                          # a high-water to keep
    before = torch.cuda.max_memory_allocated()
    probe = t.arm_mem_probe()
    t.update_step({0: x}, t.label_info(lab))
    assert probe.done and t.mem_probe is None and t.net.mem_probe is None
    labels = [m for m, _ in probe.marks]
    assert labels == [memory.START] + t.layer_scopes() + [memory.BACKWARD,
                                                          memory.UPDATE]
    assert probe.peak_bytes >= max(b for _, b in probe.marks)
    table = memory.mem_table(probe, memmodel.param_rows(t))
    rows = {r["layer"]: r for r in table["rows"]}
    assert rows["00-fc1"]["act_bytes"] >= 256 * 1024 * 4
    assert table["coverage"] > 0 and table["peak_live_bytes"] > 0
    assert t.memory_gauges()["hbm_peak_bytes"] >= before
    name = torch.cuda.get_device_name(0)
    assert costmodel.peak_flops(name) and costmodel.peak_bw(name)
    assert costmodel.hbm_bytes(name, torch.device("cuda", 0)) \
        == torch.cuda.get_device_properties(0).total_memory

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

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cxxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402

pytestmark = pytest.mark.gpu

# float32 outputs: max |got - ref| / max |ref|.  bf16 outputs: the same
# per row, within two bf16 ulps of the row's largest element (one ulp of
# a value is at most 2^-7 of it), so a wrong tile in a row of small
# values cannot hide under the largest value of the tensor.
F32_TOL, BF16_ROW_TOL = 1e-4, 2.0 ** -6


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


def _row_rel(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return float(((a - b).abs().amax(1)
                  / b.abs().amax(1).clamp_min(1e-6)).max())


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

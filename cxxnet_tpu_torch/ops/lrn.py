"""Cross-channel local response normalisation: the hand-written CUDA
kernels (``csrc/lrn.cu``), their plain PyTorch versions and the autograd
Function that ties them together.

Replaces the JAX package's Pallas ``lrn_pallas`` (``_call_per_batch``
over ``_lrn_fwd_kernel`` / ``_lrn_bwd_kernel``, pallas_kernels.py) on
logical NCHW: ``y = x * (knorm + alpha / n * sum_win x^2) ^ -beta`` with
the window ``[c - n//2, c + n - 1 - n//2]`` clipped to the channels, all
in float32 and stored in x's dtype.  The backward is the kernel's own
(the transposed window for even n); its only residual is x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

#: largest window the backward kernel takes (csrc/lrn.cu LRN_RING)
MAX_BWD_NSIZE = 32


def chwin_sum(sq: torch.Tensor, nsize: int,
              transpose: bool = False) -> torch.Tensor:
    """Window sum over axis 1 of (N, C, ...): channel j sums sq[j - lo ..
    j + hi] with lo = nsize // 2, hi = nsize - 1 - lo (the JAX package's
    ``chpool_sum`` placement); ``transpose`` swaps lo and hi (the
    adjoint window of the backward)."""
    lo = nsize // 2
    hi = nsize - 1 - lo
    if transpose:
        lo, hi = hi, lo
    c = sq.shape[1]
    pad = [0, 0] * (sq.dim() - 2) + [lo, hi]
    sp = F.pad(sq, pad)
    out = sp[:, 0:c]
    for i in range(1, nsize):
        out = out + sp[:, i:i + c]
    return out


def norm_pow(norm: torch.Tensor, beta: float) -> torch.Tensor:
    """norm^-beta; rsqrt(norm * sqrt(norm)) at beta = 0.75, as on the
    TPU."""
    if beta == 0.75:
        return torch.rsqrt(norm * torch.sqrt(norm))
    return torch.pow(norm, -beta)


def lrn_fwd_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                  knorm: float) -> torch.Tensor:
    """The forward in plain PyTorch (float32, stored in x's dtype)."""
    x32 = x.float()
    norm = chwin_sum(x32 * x32, nsize) * (alpha / nsize) + knorm
    return (x32 * norm_pow(norm, beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, nsize: int,
                  alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """dx of :func:`lrn_fwd_plain` for output gradient g, the TPU
    kernel's hand-derived form:
    ``g * norm^-b - 2 b alpha/n * x * chwin_T(g * x * norm^-b / norm)``."""
    salpha = alpha / nsize
    x32, g32 = x.float(), g.float()
    norm = chwin_sum(x32 * x32, nsize) * salpha + knorm
    npow = norm_pow(norm, beta)
    inner = g32 * x32 * (npow / norm)
    dx = g32 * npow - (2.0 * beta * salpha) * x32 * chwin_sum(
        inner, nsize, transpose=True)
    return dx.to(x.dtype)


def _check(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: expected (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype}: expected float32 or "
                         "bfloat16")
    for t in (x,) + others:
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous "
                             f"{x.dtype} {tuple(x.shape)} on one device")


def _launch(backward: bool, x, g, nsize, alpha, beta, knorm):
    n, c, h, w = x.shape
    lib = build.LIBRARY.get()
    out = torch.empty_like(x)
    err = lib.cxn_lrn(int(backward), x.data_ptr(),
                      g.data_ptr() if backward else 0, out.data_ptr(), n, c,
                      h * w, nsize, float(alpha / nsize), float(beta),
                      float(knorm), build.DTYPE_CODES[x.dtype],
                      build.stream_handle(x.device))
    build.check(err, "lrn_bwd" if backward else "lrn_fwd")
    return out


def lrn_fwd(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """LRN forward of (N, C, H, W) x.  A CUDA tensor goes through the
    CUDA kernel (or raises); a CPU tensor through :func:`lrn_fwd_plain`."""
    if x.device.type == "cpu":
        return lrn_fwd_plain(x, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_fwd: no kernel for {x.device}")
    _check("lrn_fwd", x)
    if nsize < 1:
        raise ValueError(f"lrn_fwd: local_size = {nsize}")
    y = _launch(False, x, None, nsize, alpha, beta, knorm)
    lrn_fwd.launches += 1
    return y


def lrn_bwd(x: torch.Tensor, g: torch.Tensor, nsize: int, alpha: float,
            beta: float, knorm: float) -> torch.Tensor:
    """dx of the LRN of x for output gradient g.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`lrn_bwd_plain`."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_bwd: no kernel for {x.device}")
    _check("lrn_bwd", x, g)
    if not 1 <= nsize <= MAX_BWD_NSIZE:
        raise ValueError(f"lrn_bwd: local_size = {nsize} out of range (up "
                         f"to {MAX_BWD_NSIZE})")
    dx = _launch(True, x, g, nsize, alpha, beta, knorm)
    lrn_bwd.launches += 1
    return dx


#: launches of each CUDA kernel (not of the plain versions)
lrn_fwd.launches = 0
lrn_bwd.launches = 0


class LRN(torch.autograd.Function):
    """LRN of (N, C, H, W) x: forward :func:`lrn_fwd`, backward
    :func:`lrn_bwd`; the residual is x."""

    @staticmethod
    def forward(ctx, x, nsize: int, alpha: float, beta: float,
                knorm: float):
        ctx.save_for_backward(x)
        ctx.args = (nsize, alpha, beta, knorm)
        return lrn_fwd(x, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_bwd(x, g.contiguous(), *ctx.args),
                None, None, None, None)


def lrn_pallas(x, nsize: int, alpha: float, beta: float, knorm: float):
    """Differentiable LRN through the kernels (the JAX package's name)."""
    return LRN.apply(x.contiguous(), nsize, alpha, beta, knorm)

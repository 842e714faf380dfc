"""Cross-channel local response normalisation: the hand-written CUDA
kernels (``csrc/lrn.cu``), their plain PyTorch versions and the autograd
Functions that tie them together.

Replaces the JAX package's Pallas ``lrn_pallas`` (``_call_per_batch``
over ``_lrn_fwd_kernel`` / ``_lrn_bwd_kernel``, pallas_kernels.py) on
logical NCHW: ``y = x * (knorm + alpha / n * sum_win x^2) ^ -beta`` with
the window ``[c - n//2, c + n - 1 - n//2]`` clipped to the channels, all
in float32 and stored in x's dtype.  The backward is the kernel's own
(the transposed window for even n); its only residual is x.  Both
directions take every window ``nsize >= 1``, as the JAX package's
kernels do.

And the JAX package's ``lrn_pallas_hwcn`` (``_lrn_hwcn_call``): the same
function computed on the (H, W, C, N) transpose of x by their own
kernels (``lrn_hwcn_fwd`` / ``lrn_hwcn_bwd``), behind the same shape
gate (:func:`lrn_hwcn_fits`).  On the TPU the transposes are layout
bitcasts; here they are copies, made in the autograd Function around
the kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

#: (N, C, H, W) <-> (H, W, C, N)
TO_HWCN, FROM_HWCN = (2, 3, 1, 0), (3, 2, 0, 1)


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
        raise ValueError(f"{what}: expected 4 dimensions, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype}: expected float32 or "
                         "bfloat16")
    for t in (x,) + others:
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous "
                             f"{x.dtype} {tuple(x.shape)} on one device")


#: the routes (csrc/lrn.cu LrnRoute): the window pipelined in registers,
#: for the windows in WINDOW_SIZES; in the backward (:func:`bwd_plan`) a
#: ring of the last min(n, C) channels in shared memory, or, where that
#: ring does not fit, each window recomputed; in the forward
#: (:func:`fwd_plan`) each output's window summed again ("recompute")
BWD_ROUTES = ("window", "ring", "recompute")
#: windows with a window-route instance (csrc/lrn.cu LRN_WINDOWS)
WINDOW_SIZES = (3, 4, 5, 7)
#: threads of a block; the shared memory a ring-route block may take
_THREADS = 128
_SMEM = 232448
#: bytes of the pieces a window-route thread loads where the inner axis
#: allows (16 / itemsize columns a thread)
_PIECE = 16
#: threads an SM holds on the window route, by columns a thread (the
#: kernels' launch bounds: the backward 8 blocks an SM at one column, 3
#: wider; the forward 8 and 4)
_RESIDENT = {1: 8 * _THREADS, 4: 3 * _THREADS, 8: 3 * _THREADS}
_FWD_RESIDENT = {1: 8 * _THREADS, 4: 4 * _THREADS, 8: 4 * _THREADS}
#: the waves of that residency a window-route grid should fill, C cut
#: into chunks where the columns alone fill fewer: the backward half a
#: wave, the forward two (at AlexNet's lrn1 NCHW on an H100, 1.4 waves
#: of columns ran 0.0454 ms, 2.8 waves in two chunks 0.0376: PERF.md)
_BWD_WAVES, _FWD_WAVES = 0.5, 2


class Plan(NamedTuple):
    """How a kernel covers an (outer, C, inner) array."""
    route: str      # one of BWD_ROUTES
    vec: int        # window route: columns a thread (16-byte pieces if > 1)
    chunk: int      # window route: channels a thread writes
    threads: int    # threads a block
    blocks: int     # the grid
    smem: int       # ring route: dynamic shared memory bytes a block


def _window_plan(outer: int, c: int, inner: int, nsize: int, itemsize: int,
                 aligned: bool, sms: int, resident: dict,
                 waves: float) -> Plan:
    """The window route: 16 / itemsize neighbouring columns a thread where
    the inner axis holds whole 16-byte pieces and the tensors are
    aligned, else one; where the columns fill fewer than ``waves`` waves
    of the card's ``sms`` SMs (``resident`` threads an SM by columns a
    thread), c cut into chunks of at least 4 (n - 1) channels, each
    walked by threads of their own (a chunk reads the n - 1 channels on
    either side of it again)."""
    v = max(1, _PIECE // itemsize)
    if not (aligned and inner % v == 0):
        v = 1
    groups = outer * (inner // v)
    want = math.ceil(waves * sms * resident[v] / groups)
    nchunks = max(1, min(want, c // (4 * (nsize - 1))))
    chunk = -(-c // nchunks)
    nchunks = -(-c // chunk)
    return Plan("window", v, chunk, _THREADS,
                -(-groups // _THREADS) * nchunks, 0)


def fwd_plan(outer: int, c: int, inner: int, nsize: int, itemsize: int,
             aligned: bool = True, sms: int = 132) -> Plan:
    """The forward's launch plan for x viewed as (outer, c, inner), the
    window along c; ``aligned``: x and y start on 16-byte boundaries.
    The windows in WINDOW_SIZES take the window route
    (:func:`_window_plan`), any other a column a thread on the recompute
    route."""
    if nsize in WINDOW_SIZES:
        return _window_plan(outer, c, inner, nsize, itemsize, aligned, sms,
                            _FWD_RESIDENT, _FWD_WAVES)
    cols = outer * inner
    return Plan("recompute", 1, c, _THREADS, -(-cols // _THREADS), 0)


def bwd_plan(outer: int, c: int, inner: int, nsize: int, itemsize: int,
             aligned: bool = True, sms: int = 132) -> Plan:
    """The backward's launch plan for x viewed as (outer, c, inner), the
    window along c; ``aligned``: x, g and dx start on 16-byte boundaries.

    The windows in WINDOW_SIZES take the window route
    (:func:`_window_plan`).  Other windows take the ring route while a
    ring of min(n, c) channels fits a block of 32 threads or more, else
    the recompute route."""
    if nsize in WINDOW_SIZES:
        return _window_plan(outer, c, inner, nsize, itemsize, aligned, sms,
                            _RESIDENT, _BWD_WAVES)
    cols = outer * inner
    r = min(nsize, c)
    for nt in (_THREADS, _THREADS // 2, _THREADS // 4):
        if 8 * r * nt <= _SMEM:
            return Plan("ring", 1, c, nt, -(-cols // nt), 8 * r * nt)
    return Plan("recompute", 1, c, _THREADS, -(-cols // _THREADS), 0)


def _launch(what: str, x, g, outer: int, c: int, inner: int, nsize, alpha,
            beta, knorm):
    """The kernel on x viewed as (outer, c, inner), the window along c:
    the forward on the route :func:`fwd_plan` picks, or, when the output
    gradient g is given, the backward on the route :func:`bwd_plan`
    picks."""
    out = torch.empty_like(x)
    tensors = (x, out) if g is None else (x, g, out)
    plan = (fwd_plan if g is None else bwd_plan)(
        outer, c, inner, nsize, x.element_size(),
        all(t.data_ptr() % 16 == 0 for t in tensors))
    err = build.LIBRARY.get().cxn_lrn(
        int(g is not None), x.data_ptr(), 0 if g is None else g.data_ptr(),
        out.data_ptr(), outer, c, inner, nsize, float(alpha / nsize),
        float(beta), float(knorm), BWD_ROUTES.index(plan.route), plan.vec,
        plan.chunk, build.DTYPE_CODES[x.dtype],
        build.stream_handle(x.device))
    build.check(err, what)
    return out


def lrn_fwd(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """LRN forward of (N, C, H, W) x.  A CUDA tensor goes through the
    CUDA kernel (or raises); a CPU tensor through :func:`lrn_fwd_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return lrn_fwd_plain(x, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_fwd: no kernel for {x.device}")
    _check("lrn_fwd", x)
    if nsize < 1:
        raise ValueError(f"lrn_fwd: local_size = {nsize}")
    n, c, h, w = x.shape
    y = _launch("lrn_fwd", x, None, n, c, h * w, nsize, alpha, beta, knorm)
    lrn_fwd.launches += 1
    return y


def lrn_bwd(x: torch.Tensor, g: torch.Tensor, nsize: int, alpha: float,
            beta: float, knorm: float) -> torch.Tensor:
    """dx of the LRN of x for output gradient g.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`lrn_bwd_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return lrn_bwd_plain(x, g, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_bwd: no kernel for {x.device}")
    _check("lrn_bwd", x, g)
    if nsize < 1:
        raise ValueError(f"lrn_bwd: local_size = {nsize}")
    n, c, h, w = x.shape
    dx = _launch("lrn_bwd", x, g, n, c, h * w, nsize, alpha, beta, knorm)
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


# ---------------------------------------------------------- (H, W, C, N)

def lrn_hwcn_fits(shape) -> bool:
    """The JAX package's ``_lrn_hwcn_fits`` without its TPU-backend test,
    so the same layers take the (H, W, C, N) kernels in both packages:
    batches of whole 128-image tiles, planes at most 64 wide, and a (W,
    C, 128) float32 block within 3 MiB."""
    n, c, h, w = shape
    return n % 128 == 0 and w <= 64 and w * c * 128 * 4 <= (3 << 20)


def lrn_hwcn_fwd_plain(xt: torch.Tensor, nsize: int, alpha: float,
                       beta: float, knorm: float) -> torch.Tensor:
    """:func:`lrn_fwd_plain` of the (H, W, C, N) tensor ``xt``."""
    return lrn_fwd_plain(xt.permute(FROM_HWCN), nsize, alpha, beta,
                         knorm).permute(TO_HWCN)


def lrn_hwcn_bwd_plain(xt: torch.Tensor, gt: torch.Tensor, nsize: int,
                       alpha: float, beta: float, knorm: float
                       ) -> torch.Tensor:
    """:func:`lrn_bwd_plain` of (H, W, C, N) tensors."""
    return lrn_bwd_plain(xt.permute(FROM_HWCN), gt.permute(FROM_HWCN), nsize,
                         alpha, beta, knorm).permute(TO_HWCN)


def lrn_hwcn_fwd(xt: torch.Tensor, nsize: int, alpha: float, beta: float,
                 knorm: float) -> torch.Tensor:
    """LRN forward of (H, W, C, N) xt, window along C.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`lrn_hwcn_fwd_plain`."""
    if xt.device.type in build.PLAIN_DEVICES:
        return lrn_hwcn_fwd_plain(xt, nsize, alpha, beta, knorm)
    if xt.device.type != "cuda":
        raise ValueError(f"lrn_hwcn_fwd: no kernel for {xt.device}")
    _check("lrn_hwcn_fwd", xt)
    if nsize < 1:
        raise ValueError(f"lrn_hwcn_fwd: local_size = {nsize}")
    h, w, c, n = xt.shape
    y = _launch("lrn_hwcn_fwd", xt, None, h * w, c, n, nsize, alpha, beta,
                knorm)
    lrn_hwcn_fwd.launches += 1
    return y


def lrn_hwcn_bwd(xt: torch.Tensor, gt: torch.Tensor, nsize: int,
                 alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """dx (H, W, C, N) of the LRN of xt for output gradient gt.  A CUDA
    tensor goes through the CUDA kernel (or raises); a CPU tensor through
    :func:`lrn_hwcn_bwd_plain`."""
    if xt.device.type in build.PLAIN_DEVICES:
        return lrn_hwcn_bwd_plain(xt, gt, nsize, alpha, beta, knorm)
    if xt.device.type != "cuda":
        raise ValueError(f"lrn_hwcn_bwd: no kernel for {xt.device}")
    _check("lrn_hwcn_bwd", xt, gt)
    if nsize < 1:
        raise ValueError(f"lrn_hwcn_bwd: local_size = {nsize}")
    h, w, c, n = xt.shape
    dx = _launch("lrn_hwcn_bwd", xt, gt, h * w, c, n, nsize, alpha, beta,
                 knorm)
    lrn_hwcn_bwd.launches += 1
    return dx


lrn_hwcn_fwd.launches = 0
lrn_hwcn_bwd.launches = 0


class LRNHWCN(torch.autograd.Function):
    """LRN of (N, C, H, W) x through the (H, W, C, N) kernels: x is copied
    into that layout, :func:`lrn_hwcn_fwd` runs, and y is copied back to
    contiguous NCHW; the backward transposes x and the gradient the same
    way around :func:`lrn_hwcn_bwd`.  The residual is x alone (the JAX
    package's ``_lrn_hwcn_bwd_res``)."""

    @staticmethod
    def forward(ctx, x, nsize: int, alpha: float, beta: float,
                knorm: float):
        ctx.save_for_backward(x)
        ctx.args = (nsize, alpha, beta, knorm)
        yt = lrn_hwcn_fwd(x.permute(TO_HWCN).contiguous(), *ctx.args)
        return yt.permute(FROM_HWCN).contiguous()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dxt = lrn_hwcn_bwd(x.permute(TO_HWCN).contiguous(),
                           g.permute(TO_HWCN).contiguous(), *ctx.args)
        return (dxt.permute(FROM_HWCN).contiguous(),
                None, None, None, None)


def lrn_pallas_hwcn(x, nsize: int, alpha: float, beta: float, knorm: float):
    """Differentiable LRN of NCHW x through the (H, W, C, N) kernels (the
    JAX package's name).  Gate with :func:`lrn_hwcn_fits`."""
    return LRNHWCN.apply(x, nsize, alpha, beta, knorm)

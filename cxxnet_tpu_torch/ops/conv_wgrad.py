"""Weight and bias gradient of an ungrouped strided convolution: the
hand-written CUDA kernels (``csrc/conv_wgrad.cu``), their plain PyTorch
version, and ``conv_bias_fast``, the conv + bias autograd Function whose
backward computes dW and db with them.

Replaces the JAX package's Pallas ``conv_wgrad_hwcn_pallas``
(``_cw_hwcn_kernel``, pallas_kernels.py) and the backward of
``ops/nn.py conv_bias_fast`` under ``fast_wgrad = hwcn``: dW as float32
(co, ci, kh, kw) and db as float32 (co,) from the forward's input x and
the output gradient dy, in one kernel.  Under ``fast_wgrad = s2d`` dW is
the JAX package's space-to-depth identity instead: the stride-1 weight
gradient over :func:`s2d_input`'s rearranged x, through torch.  dx goes
through the ordinary conv transpose (the JAX package leaves it to XLA).

Also replaces ``conv_wgrad_s2d_pallas`` (``_conv_wgrad_kernel``), the
backward under ``fast_wgrad = pallas``: the same dW and db, which the
TPU kernel reaches through the space-to-depth identity.  That identity
is only an order of the taps, so on the card it runs the same kernels on
the original x (no rearrangement, no fold), behind its own wrapper and
counter; its plain version keeps the JAX package's form
(:func:`conv_wgrad_s2d_plain`).

The kernels take two routes (:func:`kernel_route`): ``wgmma`` (bf16,
co <= 96, C kh kw <= 383, output rows of at most 64 positions, AlexNet's
conv1) and ``mma.sync`` (every other shape, float32 too).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from . import build

#: positions of one K-chunk of the mma.sync route (csrc/conv_wgrad.cu
#: CW_BK) and its dW tile
_BK, _BM, _BN = 32, 64, 64
#: blocks the mma.sync route's split-K grid aims at (four per SM of an H100)
_TARGET_BLOCKS = 528
#: the wgmma route's partial of a block: (taps, co) padded to (384, 96)
_WG_TAPS, _WG_CO = 384, 96
#: the kernels of csrc/conv_wgrad.cu cxn_conv_wgrad_route
ROUTES = ("mma.sync", "wgmma")


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                     stride: int, pad_y: int, pad_x: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db)`` in float32 in plain PyTorch, from float32 copies of x
    and dy."""
    x32, dy32 = x.float(), dy.float()
    dw = conv2d_weight(x32, (dy.shape[1], x.shape[1], kh, kw), dy32,
                       stride=stride, padding=(pad_y, pad_x))
    return dw, dy32.sum(dim=(0, 2, 3))


def s2d_input(x: torch.Tensor, stride: int, kh: int, kw: int, oh: int,
              ow: int, pad_y: int, pad_x: int
              ) -> Tuple[torch.Tensor, int, int]:
    """The JAX package's x-side space-to-depth rearrangement: (n, c, h,
    w) -> (n, c*s*s, hb, wb), channel order (c, sy, sx), so a stride-s
    conv of x is a stride-1 conv of the result with ``(kb_y, kb_x) =
    (ceil(kh / s), ceil(kw / s))`` kernel blocks.  Returns ``(xb, kb_y,
    kb_x)``."""
    s = stride
    n, c, h, w = x.shape
    kb_y, kb_x = -(-kh // s), -(-kw // s)
    hb, wb = oh - 1 + kb_y, ow - 1 + kb_x
    # the conv padding, then whole blocks; a strided conv may leave
    # unconsumed tail rows / columns, hence the clamp and the slice
    xp = F.pad(x, (pad_x, max(0, wb * s - w - pad_x),
                   pad_y, max(0, hb * s - h - pad_y)))[:, :, :hb * s,
                                                       :wb * s]
    xb = xp.reshape(n, c, hb, s, wb, s).permute(0, 1, 3, 5, 2, 4)
    return xb.reshape(n, c * s * s, hb, wb), kb_y, kb_x


def s2d_staged_shape(c: int, stride: int, kh: int, kw: int, oh: int,
                     ow: int) -> Tuple[int, int, int]:
    """The per-image (c * s * s, hb, wb) shape :func:`s2d_input` makes:
    what ``input_s2d = 1`` feeds the first conv."""
    kb_y, kb_x = -(-kh // stride), -(-kw // stride)
    return (c * stride * stride, oh - 1 + kb_y, ow - 1 + kb_x)


def s2d_weights(w: torch.Tensor, stride: int) -> torch.Tensor:
    """(co, ci, kh, kw) -> the stride-1 weights (co, ci*s*s, kb_y, kb_x)
    over :func:`s2d_input`'s (c, sy, sx) channel order; taps past kh / kw
    are zero."""
    s = stride
    co, ci, kh, kw = w.shape
    kb_y, kb_x = -(-kh // s), -(-kw // s)
    wp = F.pad(w, (0, kb_x * s - kw, 0, kb_y * s - kh))
    wb = wp.reshape(co, ci, kb_y, s, kb_x, s).permute(0, 1, 3, 5, 2, 4)
    return wb.reshape(co, ci * s * s, kb_y, kb_x)


def conv2d_pres2d(xb: torch.Tensor, w: torch.Tensor, *,
                  stride: int) -> torch.Tensor:
    """The stride-``stride`` conv of an input already in space-to-depth
    form (:func:`s2d_input`): a stride-1 conv with :func:`s2d_weights`.
    ``w`` keeps the canonical (co, ci, kh, kw) layout; autograd folds its
    gradient back."""
    return F.conv2d(xb, s2d_weights(w, stride).to(xb.dtype))


def conv2d_s2d(x: torch.Tensor, w: torch.Tensor, *, stride: int,
               pad_y: int = 0, pad_x: int = 0) -> torch.Tensor:
    """An ungrouped strided conv through the space-to-depth identity: the
    same contraction as ``F.conv2d`` in another order."""
    kh, kw = w.shape[2], w.shape[3]
    if w.shape[1] != x.shape[1]:
        raise ValueError("conv2d_s2d: grouped conv not supported")
    oh = (x.shape[2] + 2 * pad_y - kh) // stride + 1
    ow = (x.shape[3] + 2 * pad_x - kw) // stride + 1
    xb, _, _ = s2d_input(x, stride, kh, kw, oh, ow, pad_y, pad_x)
    return conv2d_pres2d(xb, w, stride=stride)


def s2d_fold(dwb: torch.Tensor, ci: int, stride: int, kh: int,
             kw: int) -> torch.Tensor:
    """The stride-1 weight gradient (co, ci*s*s, kb_y, kb_x) of the
    space-to-depth input -> (co, ci, kh, kw): its (c, sy, sx) channels
    fold back into the kernel's rows (dh*s + sy) and columns (dw*s +
    sx); taps past kh / kw (zero padding of the blocks) are sliced
    away."""
    s = stride
    co, _, kb_y, kb_x = dwb.shape
    dw = dwb.reshape(co, ci, s, s, kb_y, kb_x).permute(0, 1, 4, 2, 5, 3)
    return dw.reshape(co, ci, kb_y * s, kb_x * s)[:, :, :kh, :kw]


def wgrad_s2d(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
              stride: int, pad_y: int, pad_x: int) -> torch.Tensor:
    """dW (co, ci, kh, kw) through the space-to-depth identity: the
    stride-1 weight gradient over :func:`s2d_input`, folded back by
    :func:`s2d_fold`."""
    s = stride
    co, (ci, oh, ow) = dy.shape[1], (x.shape[1],) + tuple(dy.shape[2:])
    xb, kb_y, kb_x = s2d_input(x, s, kh, kw, oh, ow, pad_y, pad_x)
    dwb = conv2d_weight(xb, (co, ci * s * s, kb_y, kb_x), dy)
    return s2d_fold(dwb, ci, s, kh, kw)


def split_plan(n: int, oh: int, ow: int, co: int, taps: int
               ) -> Tuple[int, int]:
    """``(splits, chunks per split)`` of the kernel's K range: enough
    splits to give the grid ~_TARGET_BLOCKS blocks, none empty."""
    chunks = n * -(-(oh * ow) // _BK)
    tiles = -(-co // _BM) * -(-taps // _BN)
    want = max(1, min(chunks, _TARGET_BLOCKS // tiles, 65535))
    per = -(-chunks // want)
    return -(-chunks // per), per


def kernel_route(c: int, co: int, ow: int, kh: int, kw: int, stride: int,
                 dtype: torch.dtype) -> str:
    """The kernel the wgrad of a kh x kw stride ``stride`` conv of C
    channels to ``co`` at output width ``ow`` in ``dtype`` launches, as
    the C dispatcher decides it (builds the library)."""
    code = build.LIBRARY.get().cxn_conv_wgrad_route(
        c, co, ow, kh, kw, stride, build.DTYPE_CODES[dtype])
    if code < 0:
        raise ValueError(f"conv_wgrad: no kernel for C {c}, co {co}, ow "
                         f"{ow}, {kh}x{kw} stride {stride} in {dtype}")
    return ROUTES[code]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(what: str, x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if (x.dim() != 4 or dy.dim() != 4 or x.dtype not in build.DTYPE_CODES
            or dy.dtype != x.dtype or dy.device != x.device
            or not x.is_contiguous() or not dy.is_contiguous()):
        raise ValueError(f"{what}: x {x.dtype} {tuple(x.shape)}, dy "
                         f"{dy.dtype} {tuple(dy.shape)}: expected contiguous "
                         "4-d float32 or bfloat16 tensors of one dtype")


def _launch(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
            stride: int, pad_y: int, pad_x: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(dW, db)`` of the conv of x to dy."""
    n, c, h, w = x.shape
    _, co, oh, ow = dy.shape
    if (dy.shape[0] != n or oh != (h + 2 * pad_y - kh) // stride + 1
            or ow != (w + 2 * pad_x - kw) // stride + 1):
        raise ValueError(f"conv_wgrad: dy {tuple(dy.shape)} is not the "
                         f"output of a {kh}x{kw} stride {stride} conv of "
                         f"{tuple(x.shape)}")
    taps = c * kh * kw
    f32 = dict(dtype=torch.float32, device=x.device)
    if kernel_route(c, co, ow, kh, kw, stride, x.dtype) == "wgmma":
        # the kernel copies x and dy in 16-byte pieces
        x = x.clone() if x.data_ptr() % 16 else x
        dy = dy.clone() if dy.data_ptr() % 16 else dy
        # one block an SM, each over a run of whole output rows
        rows = n * oh
        per = -(-rows // min(rows, _sm_count(x.device.index or 0)))
        splits = -(-rows // per)
        part = torch.empty((splits, _WG_TAPS, _WG_CO), **f32)
        part_b = part
    else:
        splits, per = split_plan(n, oh, ow, co, taps)
        part = torch.empty((splits, co, taps), **f32)
        part_b = torch.empty((splits, co), **f32)
    dw = torch.empty((co, c, kh, kw), **f32)
    db = torch.empty((co,), **f32)
    err = build.LIBRARY.get().cxn_conv_wgrad(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), part_b.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, c, h, w, co, oh, ow, kh, kw, stride,
        pad_y, pad_x, splits, per, build.DTYPE_CODES[x.dtype],
        build.stream_handle(x.device))
    build.check(err, "conv_wgrad")
    return dw, db


def conv_wgrad_hwcn_pallas(x: torch.Tensor, dy: torch.Tensor, kh: int,
                           kw: int, stride: int, pad_y: int = 0,
                           pad_x: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW (co, ci, kh, kw), db (co,))`` in float32 of the conv of
    (N, C, H, W) x to (N, CO, OH, OW) dy.  A CUDA tensor goes through the
    CUDA kernel (or raises); a CPU tensor through
    :func:`conv_wgrad_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return conv_wgrad_plain(x, dy, kh, kw, stride, pad_y, pad_x)
    _check("conv_wgrad", x, dy)
    out = _launch(x, dy, kh, kw, stride, pad_y, pad_x)
    conv_wgrad_hwcn_pallas.launches += 1
    return out


def conv_wgrad_s2d_plain(x: torch.Tensor, dy: torch.Tensor, kh: int,
                         kw: int, stride: int, pad_y: int, pad_x: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db)`` in float32 the space-to-depth way in plain PyTorch:
    :func:`conv_wgrad_plain` at stride 1 over :func:`s2d_input`'s tensor,
    folded back by :func:`s2d_fold`."""
    ci, (oh, ow) = x.shape[1], dy.shape[2:]
    xb, kb_y, kb_x = s2d_input(x, stride, kh, kw, oh, ow, pad_y, pad_x)
    dwb, db = conv_wgrad_plain(xb, dy, kb_y, kb_x, 1, 0, 0)
    return s2d_fold(dwb, ci, stride, kh, kw), db


def conv_wgrad_s2d_pallas(x: torch.Tensor, dy: torch.Tensor, kh: int,
                          kw: int, stride: int, pad_y: int = 0,
                          pad_x: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW (co, ci, kh, kw), db (co,))`` in float32 of the stride-s
    conv of (N, C, H, W) x to (N, CO, OH, OW) dy.  A CUDA tensor goes
    through the CUDA kernel on x itself (or raises): the space-to-depth
    identity of the JAX package's kernel only reorders the taps.  A CPU
    tensor goes through :func:`conv_wgrad_s2d_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return conv_wgrad_s2d_plain(x, dy, kh, kw, stride, pad_y, pad_x)
    _check("conv_wgrad_s2d", x, dy)
    out = _launch(x, dy, kh, kw, stride, pad_y, pad_x)
    conv_wgrad_s2d_pallas.launches += 1
    return out


#: launches of each CUDA kernel (not of the plain versions)
conv_wgrad_hwcn_pallas.launches = 0
conv_wgrad_s2d_pallas.launches = 0


class ConvBiasFast(torch.autograd.Function):
    """``conv2d(x, w) + b`` (ungrouped) with dW and db from one wgrad
    (``mode`` ``hwcn``: :func:`conv_wgrad_hwcn_pallas`; ``pallas``:
    :func:`conv_wgrad_s2d_pallas`; ``s2d``: the same function as
    :func:`wgrad_s2d` and a sum, as the JAX package's default computes
    it with XLA), cast to w's dtype; dx through the conv transpose, only
    when x needs a gradient.  ``fwd_s2d`` (``conv1_fwd = s2d``): the
    forward through :func:`conv2d_s2d`."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, pad_y: int, pad_x: int,
                mode: str, fwd_s2d: bool = False):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, pad_y, pad_x, mode)
        if fwd_s2d:
            out = conv2d_s2d(x, w, stride=stride, pad_y=pad_y, pad_x=pad_x)
        else:
            out = F.conv2d(x, w.to(x.dtype), stride=stride,
                           padding=(pad_y, pad_x))
        return out + b.to(out.dtype).reshape(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, pad_y, pad_x, mode = ctx.args
        dy = dy.contiguous()
        co, ci, kh, kw = w.shape
        if mode == "hwcn":
            dw, db = conv_wgrad_hwcn_pallas(x.contiguous(), dy, kh, kw,
                                            stride, pad_y, pad_x)
        elif mode == "pallas":
            dw, db = conv_wgrad_s2d_pallas(x.contiguous(), dy, kh, kw,
                                           stride, pad_y, pad_x)
        else:
            dw = wgrad_s2d(x, dy, kh, kw, stride, pad_y, pad_x)
            db = dy.float().sum(dim=(0, 2, 3))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_input(x.shape, w.to(x.dtype), dy, stride=stride,
                              padding=(pad_y, pad_x))
        return (dx, dw.to(w.dtype), db.to(w.dtype), None, None, None, None,
                None)


def conv_bias_fast(x, w, b, stride: int, pad_y: int, pad_x: int,
                   mode: str = "hwcn", fwd_s2d: bool = False):
    """Differentiable ungrouped conv + bias with the fast wgrad."""
    return ConvBiasFast.apply(x, w, b, stride, pad_y, pad_x, mode, fwd_s2d)

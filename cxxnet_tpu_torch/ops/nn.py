"""Functional CNN ops of the layer zoo (the JAX package's ``ops/nn.py``):
the reference's size rules, grouped convolution, pooling, LRN, and the
dispatch of each to its hand-written kernel or its plain torch form by
the trainer's engine options.

All tensors are logical NCHW, as in the JAX package.  One choice here
reads the device, as the JAX package's reads its backend: the pool gate
:func:`hwcn_pool_ok` of ``pool_bwd = auto`` and ``pool_relu_fuse = 1``
holds only for a tensor on the card, so on the CPU those pools take the
one-winner backward as the JAX package's do off the TPU.  Every other
gate depends only on the options and shapes, and the kernel wrappers
alone pick kernel (CUDA tensor) or plain version (CPU tensor).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..engine import EngineOptions
from . import lrn as lrn_ops, pool
from .conv_wgrad import (conv2d_pres2d, conv2d_s2d,  # noqa: F401
                         conv_bias_fast, s2d_input, s2d_staged_shape,
                         s2d_weights)
from .pool import pool_out_size, pool_out_size_padded  # noqa: F401


def conv_out_size(in_size: int, ksize: int, stride: int, pad: int) -> int:
    """Reference conv output size ((i + 2p - k) / s + 1)."""
    return (in_size + 2 * pad - ksize) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           pad_y: int = 0, pad_x: int = 0, num_group: int = 1
           ) -> torch.Tensor:
    """Grouped 2-D convolution, NCHW x OIHW -> NCHW, w of shape (out_c,
    in_c // num_group, kh, kw).  ``F.conv2d``: the JAX package leaves
    this to XLA, outside any Pallas kernel.  Both values of
    ``group_conv`` lower to this one call: ``split``'s conv a group and
    concat computes the same function in more launches."""
    return F.conv2d(x, w.to(x.dtype), stride=stride,
                    padding=(pad_y, pad_x), groups=num_group)


def relu(x: torch.Tensor, opts: EngineOptions) -> torch.Tensor:
    """relu under ``relu_vjp``: ``out`` (default) masks the gradient by
    the output, as the reference's relu_grad (torch's relu backward);
    ``xla`` is ``max(x, 0)``, whose gradient torch, like XLA, halves
    where x == 0."""
    if opts.relu_vjp == "xla":
        return torch.maximum(x, x.new_zeros(()))
    return torch.relu(x)


def use_fast_wgrad(cin: int, stride: int, num_group: int,
                   opts: EngineOptions) -> bool:
    """The conv geometry whose dW and db come from one wgrad
    (``conv_bias_fast``): strided, few input channels, ungrouped (the
    JAX package's gate, without its device test)."""
    return (opts.fast_wgrad != "off" and num_group == 1 and stride >= 2
            and cin <= 4)


def _pool_padding(h: int, w: int, kh: int, kw: int, stride: int,
                  pad_y: int, pad_x: int
                  ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) padding that makes a plain strided
    window walk produce the reference's output size."""
    oh = pool_out_size_padded(h, kh, stride, pad_y)
    ow = pool_out_size_padded(w, kw, stride, pad_x)
    tail_h = max(0, (oh - 1) * stride + kh - h - 2 * pad_y)
    tail_w = max(0, (ow - 1) * stride + kw - w - 2 * pad_x)
    return (pad_y, pad_y + tail_h), (pad_x, pad_x + tail_w)


def _padded(x: torch.Tensor, kh: int, kw: int, stride: int, pad_y: int,
            pad_x: int, value: float) -> torch.Tensor:
    (t, b), (l_, r) = _pool_padding(x.shape[2], x.shape[3], kh, kw, stride,
                                    pad_y, pad_x)
    return F.pad(x, (l_, r, t, b), value=value)


def _max_pool_sas(x, kh, kw, stride, pad_y, pad_x):
    """Max pool with the one-winner backward of XLA's select-and-scatter
    (the JAX package's default ``pool_bwd = sas``): the gradient of a
    window goes to its first maximum in row-major order, as
    ``F.max_pool2d`` picks it.  -inf padding gives the reference's
    tail-window rule."""
    xp = _padded(x, kh, kw, stride, pad_y, pad_x, float("-inf"))
    return F.max_pool2d(xp, (kh, kw), stride)


#: the JAX package's budget for the multi-row pool backward's channel
#: tile (pallas_kernels._MR_BWD_VMEM_CAP); its pool gate reads it
_MR_BWD_CAP = 12 << 20


def _pick_cb(c: int, per_cb_bytes: int, cap: int) -> int:
    """The largest channel tile dividing c (a multiple of 8 or c itself)
    within ``cap``, else the smallest such tile (pallas_kernels._pick_cb)."""
    legal = [cb for cb in range(1, c + 1)
             if c % cb == 0 and (cb == c or cb % 8 == 0)]
    return next((cb for cb in reversed(legal)
                 if cb * per_cb_bytes <= cap), legal[0])


def hwcn_pool_fits(shape, kh: int, kw: int, stride: int, pad_y: int,
                   pad_x: int) -> bool:
    """The shape half of the JAX package's pool gate
    (``ops.nn._hwcn_pool_ok`` with ``max_pool_hwcn_supported``): an
    unpadded square window, a batch of whole 128-image tiles, and a
    channel tile of its multi-row backward within the budget
    (``_mp_mr_plan``: 3 * stride rows of (w, 128 images) at 12 bytes
    an element a channel)."""
    n, c, h, w = shape
    if not (pad_y == 0 and pad_x == 0 and kh == kw and n % 128 == 0):
        return False
    per = w * 128 * 12 * 3 * stride
    return _pick_cb(c, per, _MR_BWD_CAP) * per <= _MR_BWD_CAP


def hwcn_pool_ok(x: torch.Tensor, kh: int, kw: int, stride: int,
                 pad_y: int, pad_x: int) -> bool:
    """The JAX package's pool gate, the tensor on the card in place of
    its TPU backend (:func:`hwcn_pool_fits`).  Where it holds,
    ``pool_relu_fuse = 1`` fuses the relu into the all-ties pool and
    ``pool_bwd = auto`` takes the all-ties pool; elsewhere both keep the
    configured backward, one-winner by default."""
    return x.device.type == "cuda" and hwcn_pool_fits(
        x.shape, kh, kw, stride, pad_y, pad_x)


def max_pool2d(x: torch.Tensor, ksize_y: int, ksize_x: int, stride: int,
               pad_y: int = 0, pad_x: int = 0, *,
               opts: EngineOptions) -> torch.Tensor:
    """Max pool.  ``pool_layout = hwcn`` or ``pool_bwd = eq | gather``:
    the all-ties pool kernels (mshadow unpool: every tied maximum gets
    the window's gradient) at every shape, as the JAX package keeps
    all-ties where its kernel declines a shape; ``pool_bwd = auto``: the
    same where :func:`hwcn_pool_ok` holds; otherwise the one-winner
    plain torch pool.  ``pool_layout = chwn`` is ``nchw``'s lowering:
    the JAX package's (C, H, W, N) transpose changes only the layout XLA
    pools in, not the function or its tie order."""
    geom = (ksize_y, ksize_x, stride, pad_y, pad_x)
    if (opts.pool_layout == "hwcn" or opts.pool_bwd in ("eq", "gather")
            or (opts.pool_bwd == "auto" and hwcn_pool_ok(x, *geom))):
        return pool.max_pool_hwcn(x, *geom)
    return _max_pool_sas(x, *geom)


def max_pool2d_relu(x: torch.Tensor, ksize_y: int, ksize_x: int,
                    stride: int, pad_y: int = 0, pad_x: int = 0, *,
                    opts: EngineOptions) -> torch.Tensor:
    """``relu(max_pool2d(x))``, the deferred-relu pool of the relu->pool
    reorder.  ``pool_relu_fuse = 1`` where :func:`hwcn_pool_ok` holds:
    the relu backward fuses into the all-ties pool backward kernel
    (which implies the all-ties backward for this pool); otherwise the
    configured pool, then relu."""
    geom = (ksize_y, ksize_x, stride, pad_y, pad_x)
    if opts.pool_relu_fuse == "1" and hwcn_pool_ok(x, *geom):
        return pool.max_pool_relu_hwcn(x, *geom)
    return relu(max_pool2d(x, *geom, opts=opts), opts)


def jitter5(x: torch.Tensor, mask: torch.Tensor, p_keep: float
            ) -> torch.Tensor:
    """Insanity pooling's neighbour redirect
    (insanity_pooling_layer-inl.hpp:70-93): where ``mask`` (uniform [0,
    1), x's shape) falls in the band [p, p + d), [p + d, p + 2d), ...
    (d = (1 - p) / 4) a position reads its y-1, y+1, x-1 or x+1
    neighbour (clamped at the edge), below p itself."""
    d = (1.0 - p_keep) / 4.0
    up = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
    down = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    left = torch.cat([x[:, :, :, :1], x[:, :, :, :-1]], dim=3)
    right = torch.cat([x[:, :, :, 1:], x[:, :, :, -1:]], dim=3)
    return torch.where(mask < p_keep, x,
           torch.where(mask < p_keep + d, up,
           torch.where(mask < p_keep + 2 * d, down,
           torch.where(mask < p_keep + 3 * d, left, right))))


def insanity_max_pool(x: torch.Tensor, mask: torch.Tensor, ksize_y: int,
                      ksize_x: int, stride: int, p_keep: float
                      ) -> torch.Tensor:
    """Training insanity pooling (insanity_pooling_layer-inl.hpp): the
    all-ties max pool of the jittered image, whose gradient goes to the
    window position itself (the reference's insanity_unpool), not
    through the redirect: the value is the jittered image, the gradient
    passes straight through to x."""
    xj = jitter5(x, mask, p_keep)
    xj = x + (xj - x).detach()
    return pool.max_pool_hwcn(xj, ksize_y, ksize_x, stride)


def sum_pool2d(x: torch.Tensor, ksize_y: int, ksize_x: int, stride: int,
               pad_y: int = 0, pad_x: int = 0) -> torch.Tensor:
    """Window sums, zero padding and the reference's tail windows."""
    xp = _padded(x, ksize_y, ksize_x, stride, pad_y, pad_x, 0.0)
    return F.avg_pool2d(xp, (ksize_y, ksize_x), stride, divisor_override=1)


def avg_pool2d(x: torch.Tensor, ksize_y: int, ksize_x: int, stride: int,
               pad_y: int = 0, pad_x: int = 0) -> torch.Tensor:
    """Average pooling that divides by the FULL kernel size, even for a
    clipped tail window or padding (pooling_layer-inl.hpp:47-53);
    ``F.avg_pool2d(ceil_mode=True)`` would divide tail windows by fewer."""
    s = sum_pool2d(x, ksize_y, ksize_x, stride, pad_y, pad_x)
    return s * torch.tensor(1.0 / (ksize_y * ksize_x), dtype=x.dtype)


def chpool_sum(x: torch.Tensor, nsize: int) -> torch.Tensor:
    """Cross-channel window sum (mshadow ``chpool<red::sum>``): channel c
    sums [c - nsize // 2, c + nsize - 1 - nsize // 2]."""
    return lrn_ops.chwin_sum(x, nsize)


def lrn(x: torch.Tensor, nsize: int, alpha: float, beta: float,
        knorm: float, *, opts: EngineOptions) -> torch.Tensor:
    """Local response normalisation across channels
    (lrn_layer-inl.hpp:53-56): ``x * (knorm + alpha / n * sum x^2) ^
    -beta``.  ``pallas_lrn = 1``: the LRN kernels; ``hwcn``: the (H, W,
    C, N) LRN kernels where the shape passes their gate, else, as in the
    JAX package, the plain form; band / bandconv / 0: the same function
    in plain torch under autograd."""
    if opts.pallas_lrn == "1":
        return lrn_ops.lrn_pallas(x, nsize, alpha, beta, knorm)
    if opts.pallas_lrn == "hwcn" and lrn_ops.lrn_hwcn_fits(x.shape):
        return lrn_ops.lrn_pallas_hwcn(x, nsize, alpha, beta, knorm)
    norm = chpool_sum(torch.square(x), nsize) * (alpha / nsize) + knorm
    return x * lrn_ops.norm_pow(norm, beta)


def uniform(gen: torch.Generator, shape, dtype: torch.dtype
            ) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` on its device (insanity,
    prelu's noise)."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=dtype)


def dropout_mask(gen: torch.Generator, shape, pkeep: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """Reference dropout mask: threshold(uniform, pkeep) / pkeep
    (dropout_layer-inl.hpp:46-48), drawn from ``gen`` on its device."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return (u < pkeep).to(dtype) * (1.0 / pkeep)


def batch_draw(draw, ctx, shape, *args) -> torch.Tensor:
    """``draw(ctx.rng, shape, *args)`` (:func:`uniform`,
    :func:`dropout_mask`) of a training forward's batch-shaped random
    mask.  On a data mesh (``ctx.mesh``) ``shape`` holds the rank's rows:
    the draw is the whole batch's and the rank keeps its rows, so its
    masks are those one device draws for the same rows (every rank's
    generator moves in step)."""
    from ..parallel.data import data_size, row_slice
    nd = data_size(ctx.mesh)
    if nd == 1:
        return draw(ctx.rng, shape, *args)
    full = (shape[0] * nd,) + tuple(shape[1:])
    return draw(ctx.rng, full, *args)[row_slice(ctx.mesh, full[0])]

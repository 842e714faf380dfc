"""Functional CNN ops of the layer zoo (the JAX package's ``ops/nn.py``):
the reference's size rules, grouped convolution, pooling, LRN, and the
dispatch of each to its hand-written kernel or its plain torch form by
the trainer's engine options.

All tensors are logical NCHW, as in the JAX package.  Unlike the JAX
package, no choice here reads the device: the gates depend only on the
options and shapes, so the CPU and the card build the same graph, and
the kernel wrappers alone pick kernel (CUDA tensor) or plain version
(CPU tensor).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..engine import EngineOptions
from . import lrn as lrn_ops, pool
from .conv_wgrad import conv_bias_fast, s2d_input  # noqa: F401
from .pool import pool_out_size, pool_out_size_padded  # noqa: F401


def conv_out_size(in_size: int, ksize: int, stride: int, pad: int) -> int:
    """Reference conv output size ((i + 2p - k) / s + 1)."""
    return (in_size + 2 * pad - ksize) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           pad_y: int = 0, pad_x: int = 0, num_group: int = 1
           ) -> torch.Tensor:
    """Grouped 2-D convolution, NCHW x OIHW -> NCHW, w of shape (out_c,
    in_c // num_group, kh, kw).  ``F.conv2d``: the JAX package leaves
    this to XLA, outside any Pallas kernel."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(pad_y, pad_x),
                    groups=num_group)


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


def _all_ties(opts: EngineOptions) -> bool:
    return opts.pool_layout == "hwcn" or opts.pool_bwd in ("eq", "gather")


def max_pool2d(x: torch.Tensor, ksize_y: int, ksize_x: int, stride: int,
               pad_y: int = 0, pad_x: int = 0, *,
               opts: EngineOptions) -> torch.Tensor:
    """Max pool.  ``pool_layout = hwcn`` or ``pool_bwd = eq | gather``:
    the all-ties pool kernels (mshadow unpool: every tied maximum gets
    the window's gradient), for every shape; otherwise the one-winner
    plain torch pool."""
    if _all_ties(opts):
        return pool.max_pool_hwcn(x, ksize_y, ksize_x, stride, pad_y, pad_x)
    return _max_pool_sas(x, ksize_y, ksize_x, stride, pad_y, pad_x)


def max_pool2d_relu(x: torch.Tensor, ksize_y: int, ksize_x: int,
                    stride: int, pad_y: int = 0, pad_x: int = 0, *,
                    opts: EngineOptions) -> torch.Tensor:
    """``relu(max_pool2d(x))``, the deferred-relu pool of the relu->pool
    reorder.  ``pool_relu_fuse = 1``: the relu backward fuses into the
    all-ties pool backward kernel (which implies the all-ties backward
    for this pool); otherwise the configured pool, then relu."""
    if opts.pool_relu_fuse == "1":
        return pool.max_pool_relu_hwcn(x, ksize_y, ksize_x, stride, pad_y,
                                       pad_x)
    return torch.relu(max_pool2d(x, ksize_y, ksize_x, stride, pad_y, pad_x,
                                 opts=opts))


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


def dropout_mask(gen: torch.Generator, shape, pkeep: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """Reference dropout mask: threshold(uniform, pkeep) / pkeep
    (dropout_layer-inl.hpp:46-48), drawn from ``gen`` on its device."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return (u < pkeep).to(dtype) * (1.0 / pkeep)

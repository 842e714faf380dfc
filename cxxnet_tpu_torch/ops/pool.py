"""Max pooling with the all-ties backward: the hand-written CUDA kernels
(``csrc/max_pool.cu``), their plain PyTorch versions and the autograd
Functions of the plain and the relu-fused pool.

Replaces the JAX package's Pallas ``max_pool_hwcn`` /
``max_pool_relu_hwcn`` (``_mp_hwcn_fwd`` and ``_mp_hwcn_bwd``,
pallas_kernels.py) on logical NCHW: the forward takes the max over each
window clipped to the input (the reference's tail-window rule; the
output size is ``ops.nn.pool_out_size_padded``), and the backward is
mshadow's unpool, where every input equal to its window's max gets that
window's gradient, summed in float32 in the TPU kernel's order (window
rows ascending, window columns descending).  ``relu`` masks each
window's gradient where the pooled (pre-relu) value is not positive:
the backward of ``relu(max_pool(x))``.  Unlike the TPU kernel, the
kernels take padding and non-square windows.  The residuals are ``(x,
pre-relu pooled output)``, as on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build


def pool_out_size(in_size: int, ksize: int, stride: int) -> int:
    """Reference pooling output size (pooling_layer-inl.hpp:103-106),
    with a clipped tail window when (in - k) is not divisible by s."""
    return min(in_size - ksize + stride - 1, in_size - 1) // stride + 1


def pool_out_size_padded(in_size: int, ksize: int, stride: int,
                         pad: int) -> int:
    """Pool output size with symmetric leading padding, capped so the
    last window still holds an input element."""
    o = pool_out_size(in_size + 2 * pad, ksize, stride)
    return min(o, (in_size - 1 + pad) // stride + 1)


Geom = Tuple[int, int, int, int, int]   # kh, kw, stride, pad_y, pad_x


def _out_shape(x: torch.Tensor, geom: Geom) -> Tuple[int, int]:
    kh, kw, s, py, px = geom
    return (pool_out_size_padded(x.shape[2], kh, s, py),
            pool_out_size_padded(x.shape[3], kw, s, px))


def _cand(in_size: int, k: int, s: int, pad: int, out_size: int):
    """For each input position a, the windows covering it: w in
    [ceil((a + pad - k + 1) / s), floor((a + pad) / s)] within [0,
    out_size).  Returns (ncand, in_size) indices and validity."""
    a = np.arange(in_size) + pad
    lo = np.maximum(-(-(a - k + 1) // s), 0)
    hi = np.minimum(a // s, out_size - 1)
    ncand = int(np.max(hi - lo + 1))
    idx = np.stack([lo + t for t in range(ncand)])
    return torch.from_numpy(np.clip(idx, 0, out_size - 1)), idx <= hi


def max_pool_fwd_plain(x: torch.Tensor, geom: Geom) -> torch.Tensor:
    """The forward in plain PyTorch: max over the taps of each window,
    taps outside the input skipped."""
    kh, kw, s, py, px = geom
    oh, ow = _out_shape(x, geom)
    h, w = x.shape[2], x.shape[3]
    out = None
    for i in range(kh):
        rows = np.arange(oh) * s - py + i
        rv = (rows >= 0) & (rows < h)
        for j in range(kw):
            cols = np.arange(ow) * s - px + j
            cv = (cols >= 0) & (cols < w)
            tap = x[:, :, torch.from_numpy(np.clip(rows, 0, h - 1))][
                :, :, :, torch.from_numpy(np.clip(cols, 0, w - 1))]
            valid = torch.from_numpy(rv[:, None] & cv[None, :]).to(x.device)
            tap = torch.where(valid, tap, float("-inf"))
            out = tap if out is None else torch.maximum(out, tap)
    return out


def max_pool_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                       geom: Geom, relu: bool = False) -> torch.Tensor:
    """The all-ties backward in plain PyTorch: per input, the gradients of
    the covering windows whose max equals it (and, under ``relu``, is
    positive), summed in float32 in the kernel's order."""
    kh, kw, s, py, px = geom
    oh, ow = y.shape[2], y.shape[3]
    iy, vy = _cand(x.shape[2], kh, s, py, oh)
    ix, vx = _cand(x.shape[3], kw, s, px, ow)
    x32, y32, dy32 = x.float(), y.float(), dy.float()
    acc = torch.zeros_like(x32)
    for t in range(iy.shape[0]):
        y_r, dy_r = y32[:, :, iy[t]], dy32[:, :, iy[t]]
        for u in reversed(range(ix.shape[0])):
            y_c, dy_c = y_r[:, :, :, ix[u]], dy_r[:, :, :, ix[u]]
            m = torch.from_numpy(vy[t][:, None] & vx[u][None, :]).to(x.device)
            m = m & (x32 == y_c)
            if relu:
                m = m & (y_c > 0)
            acc = acc + torch.where(m, dy_c, 0.0)
    return acc.to(x.dtype)


#: the forward's routes (csrc/max_pool.cu), chosen by :func:`fwd_plan`: a
#: block a group of whole planes whose x and y pass through shared
#: memory, a thread an output column, for the windows in CELL_WINDOWS; or
#: a thread an output element
FWD_ROUTES = ("cells", "per-output")
#: the backward's routes (csrc/max_pool.cu), chosen by :func:`bwd_plan`:
#: a block a group of whole planes whose x and dx pass through shared
#: memory, a thread the input columns between two window starts, for the
#: windows in CELL_WINDOWS; or a thread an input element
BWD_ROUTES = ("cells", "gather")
#: (square window size, stride) pairs of the cells route
#: (csrc/max_pool.cu mp_cells_kernel); any padding
CELL_WINDOWS = ((3, 2), (3, 1), (2, 2))
#: threads of a cells-route block; the shared memory a backward and a
#: forward block may take
_CELL_THREADS = 256
BWD_SMEM = 64 * 1024
FWD_SMEM = 64 * 1024


class BwdPlan(NamedTuple):
    """How the all-ties backward (or the forward: :class:`FwdPlan`)
    covers (planes, h, w) inputs."""
    route: str      # one of BWD_ROUTES (FWD_ROUTES)
    cells: int      # cells route: threads a plane: column cells,
                    # ceil((w + px) / s) (the forward: output columns)
    group: int      # cells route: planes a block
    blocks: int     # cells route: the grid, ceil(planes / group)
    smem: int       # cells route: shared memory bytes a block


class FwdPlan(BwdPlan):
    """How the forward covers (planes, h, w) inputs (``cells``: output
    columns a plane)."""
    __slots__ = ()


def bwd_smem(group: int, h: int, w: int, itemsize: int) -> int:
    """Shared memory of ``group`` (h, w) planes in a cells-route block
    (csrc/max_pool.cu mp_cap): the group's elements after a shift of up
    to a 16-byte piece, in whole pieces.  A backward block holds x (then
    dx) so; a forward block holds x, then y."""
    v = 16 // itemsize
    return (group * h * w + 2 * v - 2) // v * v * itemsize


def _cells_group(planes: int, cells: int, smem, budget: int,
                 sms: int) -> int:
    """Planes a cells-route block owns: as many as give each of its
    threads one cell, fewer where ``smem(group)`` passes ``budget`` or the
    grid would leave SMs of a card of ``sms`` without two blocks."""
    group = max(1, min(_CELL_THREADS // cells, -(-planes // (2 * sms))))
    while group > 1 and smem(group) > budget:
        group -= 1
    return group


def bwd_plan(planes: int, h: int, w: int, geom: Geom, itemsize: int,
             aligned: bool = True, sms: int = 132) -> BwdPlan:
    """The backward's launch plan; ``aligned``: x and dx start on 16-byte
    boundaries.  Block b of the cells route owns planes [b group, (b + 1)
    group) (:func:`_cells_group`); cell t holds input columns [t s -
    pad_x, (t + 1) s - pad_x)."""
    kh, kw, s, py, px = geom
    cells = -(-(w + px) // s)
    smem = lambda g: bwd_smem(g, h, w, itemsize)  # noqa: E731
    group = _cells_group(planes, cells, smem, BWD_SMEM, sms)
    if (kh != kw or (kw, s) not in CELL_WINDOWS or not aligned
            or smem(group) > BWD_SMEM):
        return BwdPlan("gather", 0, 0, 0, 0)
    return BwdPlan("cells", cells, group, -(-planes // group), smem(group))


def fwd_plan(planes: int, h: int, w: int, geom: Geom, itemsize: int,
             aligned: bool = True, sms: int = 132) -> FwdPlan:
    """The forward's launch plan; ``aligned``: x and y start on 16-byte
    boundaries.  Block b of the cells route owns planes [b group, (b + 1)
    group) (:func:`_cells_group`), a thread each output column of each,
    and stages the group's x and y."""
    kh, kw, s, py, px = geom
    oh = pool_out_size_padded(h, kh, s, py)
    ow = pool_out_size_padded(w, kw, s, px)
    smem = lambda g: (bwd_smem(g, h, w, itemsize)  # noqa: E731
                      + bwd_smem(g, oh, ow, itemsize))
    group = _cells_group(planes, ow, smem, FWD_SMEM, sms)
    if (kh != kw or (kw, s) not in CELL_WINDOWS or not aligned
            or smem(group) > FWD_SMEM):
        return FwdPlan("per-output", 0, 0, 0, 0)
    return FwdPlan("cells", ow, group, -(-planes // group), smem(group))


def fwd_route(x: torch.Tensor, geom: Geom, aligned: bool = True) -> str:
    """The forward route of (N, C, H, W) x under ``geom``; ``aligned``: x
    and y start on 16-byte boundaries."""
    return fwd_plan(x.shape[0] * x.shape[1], x.shape[2], x.shape[3], geom,
                    x.element_size(), aligned).route


def bwd_route(x: torch.Tensor, geom: Geom, aligned: bool = True) -> str:
    """The backward route of (N, C, H, W) x under ``geom``; ``aligned``:
    x and dx start on 16-byte boundaries."""
    return bwd_plan(x.shape[0] * x.shape[1], x.shape[2], x.shape[3], geom,
                    x.element_size(), aligned).route


def _check(what: str, x: torch.Tensor, geom: Geom) -> None:
    kh, kw, s, py, px = geom
    if x.dim() != 4 or x.dtype not in build.DTYPE_CODES \
            or not x.is_contiguous():
        raise ValueError(f"{what}: expected contiguous float32 or bfloat16 "
                         f"(N, C, H, W), got {x.dtype} {tuple(x.shape)}")
    if min(kh, kw, s) < 1 or not (0 <= py < kh and 0 <= px < kw) \
            or kh > x.shape[2] + 2 * py or kw > x.shape[3] + 2 * px:
        raise ValueError(f"{what}: window {geom} does not fit "
                         f"{tuple(x.shape)}")


def _launch(backward: bool, relu: bool, x, y, dy, out, geom: Geom) -> None:
    kh, kw, s, py, px = geom
    n, c, h, w = x.shape
    oh, ow = _out_shape(x, geom)
    plan = (bwd_plan if backward else fwd_plan)(
        n * c, h, w, geom, x.element_size(),
        all(t.data_ptr() % 16 == 0 for t in (x, out)))
    err = build.LIBRARY.get().cxn_max_pool(
        int(backward), int(relu), x.data_ptr(),
        y.data_ptr() if backward else 0, dy.data_ptr() if backward else 0,
        out.data_ptr(), n * c, h, w, oh, ow, kh, kw, s, py, px, plan.cells,
        plan.group, build.DTYPE_CODES[x.dtype],
        build.stream_handle(x.device))
    build.check(err, "max_pool_bwd" if backward else "max_pool_fwd")


def max_pool_fwd(x: torch.Tensor, geom: Geom) -> torch.Tensor:
    """Max pool of (N, C, H, W) x with ``geom = (kh, kw, stride, pad_y,
    pad_x)``.  A CUDA tensor goes through the CUDA kernel (or raises); a
    CPU tensor through :func:`max_pool_fwd_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return max_pool_fwd_plain(x, geom)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_fwd: no kernel for {x.device}")
    _check("max_pool_fwd", x, geom)
    y = torch.empty(x.shape[:2] + _out_shape(x, geom), dtype=x.dtype,
                    device=x.device)
    _launch(False, False, x, None, None, y, geom)
    max_pool_fwd.launches += 1
    return y


def max_pool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                 geom: Geom, relu: bool = False) -> torch.Tensor:
    """The all-ties dx from the forward's input x, its (pre-relu) output
    y and the output gradient dy.  A CUDA tensor goes through the CUDA
    kernel (or raises); a CPU tensor through :func:`max_pool_bwd_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return max_pool_bwd_plain(x, y, dy, geom, relu)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_bwd: no kernel for {x.device}")
    _check("max_pool_bwd", x, geom)
    want = x.shape[:2] + _out_shape(x, geom)
    for name, t in (("y", y), ("dy", dy)):
        if (t.shape != want or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"max_pool_bwd: {name} must be a contiguous "
                             f"{x.dtype} {tuple(want)}")
    dx = torch.empty_like(x)
    _launch(True, relu, x, y, dy, dx, geom)
    max_pool_bwd.launches += 1
    max_pool_bwd.relu_launches += int(relu)
    return dx


#: launches of each CUDA kernel (not of the plain versions); of the
#: backward's, those with the relu mask
max_pool_fwd.launches = 0
max_pool_bwd.launches = 0
max_pool_bwd.relu_launches = 0


class MaxPool(torch.autograd.Function):
    """``max_pool(x)`` (``relu`` false) or ``relu(max_pool(x))`` (``relu``
    true), the backward all-ties; residuals ``(x, pre-relu output)``."""

    @staticmethod
    def forward(ctx, x, geom: Geom, relu: bool):
        y = max_pool_fwd(x, geom)
        ctx.save_for_backward(x, y)
        ctx.geom, ctx.relu = geom, relu
        return torch.relu(y) if relu else y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return (max_pool_bwd(x, y, dy.contiguous(), ctx.geom, ctx.relu),
                None, None)


def max_pool_hwcn(x, kh: int, kw: int, stride: int, pad_y: int = 0,
                  pad_x: int = 0):
    """All-ties max pool through the kernels (the JAX package's name)."""
    return MaxPool.apply(x.contiguous(), (kh, kw, stride, pad_y, pad_x),
                         False)


def max_pool_relu_hwcn(x, kh: int, kw: int, stride: int, pad_y: int = 0,
                       pad_x: int = 0):
    """``relu(max_pool(x))`` with the relu backward fused into the
    all-ties pool backward kernel."""
    return MaxPool.apply(x.contiguous(), (kh, kw, stride, pad_y, pad_x),
                         True)

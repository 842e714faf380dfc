"""Launch plans of the port's kernels, decided in Python from the shape,
on the CPU.

The layernorm backward (``layernorm.bwd_plan``) and the all-ties max-pool
backward (``pool.bwd_plan``) are launched by the CUDA kernels exactly as
their plans say, so the plans carry the properties the kernels rely on:
every row, column and input element is covered once, 16-byte loads only
where every row starts on a 16-byte boundary, the pool's windows visited
in the gather order, and the fast route at the main paths' shapes.  The
walks below repeat the kernels' index arithmetic
(``csrc/layernorm_bwd.cu``, ``csrc/max_pool.cu``) over the plans.  This
file imports only torch and the port.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402
from cxxnet_tpu_torch.ops import pool  # noqa: E402

# ------------------------------------------------------------ layernorm

def _ln_rows_walked(rows, plan):
    """Rows each register-route row slot or stream-route run visits."""
    if plan.route == "register":
        slots = 8 // plan.warps
        step = plan.blocks * slots
        return [list(range(b * slots + s, rows, step))
                for b in range(plan.blocks) for s in range(slots)]
    per = -(-rows // plan.blocks)
    return [list(range(k * per, min(rows, (k + 1) * per)))
            for k in range(plan.blocks)]


def _ln_cols_walked(d, plan, itemsize):
    """Columns the threads of a register-route row own, once each."""
    v = 16 // itemsize if plan.vec else 1
    tg = 32 * plan.warps
    cols = [(i * tg + t) * v + e for t in range(tg)
            for i in range(plan.el // v) for e in range(v)]
    return [c for c in cols if c < d]


@pytest.mark.parametrize("d,route", [
    (1, "register"), (100, "register"), (2048, "register"),
    (2056, "register"), (4096, "register"), (4097, "stream"),
    (14512, "stream"), (14520, "stream"), (16384, "stream"),
    (43648, "stream"), (ln.MAX_D, "stream")])
def test_layernorm_bwd_route_takes_every_width(d, route):
    """Every width the forward takes (up to MAX_D) has a backward
    route."""
    assert ln.bwd_route(d) == route
    for itemsize in (2, 4):
        for aligned in (False, True):
            plan = ln.bwd_plan(37, d, itemsize, aligned)
            assert plan.route == route and plan.blocks >= 1


@pytest.mark.parametrize("rows,d", [
    (1, 1), (37, 100), (1000, 64), (300, 2048), (16384, 2048), (3, 2056),
    (37, 4096), (1, 14520), (37, 14521), (16384, 16384), (8, ln.MAX_D)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("aligned", [False, True])
def test_layernorm_bwd_plan_covers_every_row_and_column_once(rows, d,
                                                             itemsize,
                                                             aligned):
    plan = ln.bwd_plan(rows, d, itemsize, aligned)
    walked = _ln_rows_walked(rows, plan)
    assert len(walked) == plan.parts
    flat = sorted(r for w in walked for r in w)
    assert flat == list(range(rows))
    v = 16 // itemsize
    # 16-byte loads only where every row starts on a 16-byte boundary
    assert plan.vec == (aligned and d % v == 0)
    if plan.route == "register":
        assert d <= ln.BWD_REG_MAX_D and plan.el in (8, 16)
        assert plan.warps in (1, 2, 4, 8)
        assert sorted(_ln_cols_walked(d, plan, itemsize)) == list(range(d))
        assert plan.el % (v if plan.vec else 1) == 0
    else:
        assert all(walked) and plan.blocks <= min(rows, 65535)
        strips = -(-d // (256 * (v if plan.vec else 1)))
        assert strips * 256 * (v if plan.vec else 1) >= d


def test_layernorm_bwd_plan_fast_route_at_the_training_shape():
    """The LM's (batch 4 x 4096, 2048) bf16 backward: registers, 16-byte
    loads, a row over 8 warps, a persistent grid of 3 blocks an SM."""
    plan = ln.bwd_plan(16384, 2048, 2, True, sms=132)
    assert plan == ln.BwdPlan("register", True, 8, 8, 396, 396)
    # the served width's decode rows fit one block
    assert ln.bwd_plan(4, 2048, 2).blocks == 4


# -------------------------------------------------------------- max pool

POOL_SHAPES = [
    # (N, C, H, W), (kh, kw, stride, pad_y, pad_x), route
    ((256, 96, 55, 55), (3, 3, 2, 0, 0), "cells"),    # AlexNet pool1
    ((256, 256, 27, 27), (3, 3, 2, 0, 0), "cells"),   # pool2
    ((256, 256, 13, 13), (3, 3, 2, 0, 0), "cells"),   # pool3
    ((100, 32, 14, 14), (3, 3, 2, 0, 0), "cells"),    # MNIST_CONV
    ((2, 8, 28, 28), (3, 3, 1, 1, 1), "cells"),       # 3x3 stride 1, padded
    ((2, 8, 12, 13), (2, 2, 2, 1, 1), "cells"),       # 2x2 stride 2, padded
    ((2, 8, 9, 10), (3, 2, 1, 1, 1), "gather"),       # not square
    ((2, 8, 9, 10), (2, 2, 1, 1, 1), "gather"),       # 2x2 at stride 1
    ((2, 5, 55, 55), (5, 5, 3, 1, 1), "gather"),
    ((1, 3, 700, 700), (3, 3, 2, 0, 0), "gather"),    # a plane past 64 KB
]


def _gather_windows(ix, kw, s, px, ow):
    """The gather order's windows of input column ix: columns descending
    from min((ix + px) / s, ow - 1) to ceil((ix + px - kw + 1) / s)."""
    hi = min((ix + px) // s, ow - 1)
    lo = max(-((kw - 1 - ix - px) // s), 0)
    return list(range(hi, lo - 1, -1))


def _cell_windows(t, p, k, s, n_out):
    """The cells route (csrc/max_pool.cu mp_cells_kernel) along one axis:
    position p of cell t lies under windows t - j, j = 0 .. (k - 1) / s,
    where j s + p <= k - 1 and the window lies in the output."""
    return [t - j for j in range((k - 1) // s + 1)
            if j * s + p <= k - 1 and 0 <= t - j < n_out]


@pytest.mark.parametrize("shape,geom,route", POOL_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_max_pool_bwd_plan_covers_every_plane_and_column_once(
        shape, geom, route, itemsize):
    n, c, h, w = shape
    planes = n * c
    plan = pool.bwd_plan(planes, h, w, geom, itemsize)
    assert plan.route == route
    assert pool.bwd_plan(planes, h, w, geom, itemsize,
                         aligned=False).route == "gather"
    if route == "gather":
        return
    kh, kw, s, py, px = geom
    # the cells tile a row: column ix in cell (ix + px) // s, once
    cols = sorted(t * s - px + p for t in range(plan.cells)
                  for p in range(s) if 0 <= t * s - px + p < w)
    assert cols == list(range(w))
    # the groups tile the planes, and a group's x (after a shift of up
    # to one 16-byte piece, in whole pieces) fits the block's budget
    groups = [range(b * plan.group, min(planes, (b + 1) * plan.group))
              for b in range(plan.blocks)]
    assert all(groups)
    assert sorted(p for g in groups for p in g) == list(range(planes))
    v = 16 // itemsize
    assert plan.smem % 16 == 0 and plan.smem <= pool.BWD_SMEM <= 232448
    assert plan.smem >= (plan.group * h * w + v - 1) * itemsize


@pytest.mark.parametrize("shape,geom,route", POOL_SHAPES[:6])
def test_max_pool_bwd_cells_keep_the_gather_order(shape, geom, route):
    """Along rows and along columns, every position of every cell lies
    under exactly its gather windows; the kernel walks them in the gather
    order (rows ascending: j descending; columns descending: j
    ascending)."""
    n, c, h, w = shape
    kh, kw, s, py, px = geom
    for size, k, pad in ((w, kw, px), (h, kh, py)):
        n_out = pool.pool_out_size_padded(size, k, s, pad)
        for t in range(-(-(size + pad) // s)):
            for p in range(s):
                a = t * s - pad + p
                if 0 <= a < size:
                    assert _cell_windows(t, p, k, s, n_out) == \
                        _gather_windows(a, k, s, pad, n_out), (t, p)


def test_max_pool_bwd_plan_fast_route_at_alexnets_pools():
    """AlexNet's three pools (3x3 stride 2) take the cells route, with
    every SM given four blocks or more; pool1 in bf16 stages 9 planes a
    block (28 cells each, 252 threads) in 54 KB."""
    geom = (3, 3, 2, 0, 0)
    for (n, c, h, w), cells in (((256, 96, 55, 55), 28),
                                ((256, 256, 27, 27), 14),
                                ((256, 256, 13, 13), 7)):
        for itemsize in (2, 4):
            plan = pool.bwd_plan(n * c, h, w, geom, itemsize)
            assert plan.route == "cells" and plan.cells == cells
            assert plan.blocks >= 132 * 4
    assert pool.bwd_plan(256 * 96, 55, 55, geom, 2) == pool.BwdPlan(
        "cells", 28, 9, 2731, 54464)

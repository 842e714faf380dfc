"""Launch plans of the port's kernels, decided in Python from the shape,
on the CPU.

The layernorm backward (``layernorm.bwd_plan``), the LRN forward and
backward (``lrn.fwd_plan``, ``lrn.bwd_plan``) and the max-pool forward
and all-ties backward
(``pool.fwd_plan``, ``pool.bwd_plan``) are launched by the CUDA kernels
exactly as their plans say, so the plans carry the properties the
kernels rely on: every row, column, channel, input and output element is
covered once, 16-byte loads only where every row starts on a 16-byte
boundary, the LRN windows summed as ``lrn.chwin_sum`` sums them, the
pool's windows visited in the gather order and read exactly, and the
fast route at the main paths' shapes.  The walks below repeat the
kernels' index arithmetic (``csrc/layernorm_bwd.cu``, ``csrc/lrn.cu``,
``csrc/max_pool.cu``) over the plans.  This file imports only torch and
the port.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu_torch.ops import layernorm as ln  # noqa: E402
from cxxnet_tpu_torch.ops import lrn  # noqa: E402
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


# ------------------------------------------------------------------- LRN

@pytest.mark.parametrize("sizes", [range(1, 251), range(251, 501),
                                   range(501, 751), range(751, 1001)])
def test_lrn_bwd_plan_takes_every_window(sizes):
    """Every window n >= 1 at every C has a route: the window route at
    the compiled windows, the ring while min(n, C) channels of it fit a
    block of 32 threads or more, the recompute route past that."""
    for nsize in sizes:
        for c in range(1, 1001):
            plan = lrn.bwd_plan(3, c, 5, nsize, 2)
            r = min(nsize, c)
            if nsize in lrn.WINDOW_SIZES:
                assert plan.route == "window" and plan.vec == 1
                assert 1 <= plan.chunk <= c and plan.smem == 0
                assert plan.blocks == -(-c // plan.chunk)
            elif 8 * r * 32 <= lrn._SMEM:
                assert plan.route == "ring"
                assert plan.smem == 8 * r * plan.threads <= lrn._SMEM
                assert (plan.threads == lrn._THREADS
                        or 16 * r * plan.threads > lrn._SMEM)
            else:
                assert plan.route == "recompute" and plan.smem == 0


#: AlexNet's two LRN layers: (N, C, H, W) at batch 256, window 5
LRN_LAYERS = {"lrn1": (256, 96, 27, 27), "lrn2": (256, 256, 13, 13)}


@pytest.mark.parametrize("layer", sorted(LRN_LAYERS))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_lrn_bwd_plan_fast_route_at_alexnets_layers(layer, itemsize):
    """Both views of lrn1 and lrn2 take the window route: NCHW (odd
    planes) a column a thread, (H, W, C, N) 16-byte pieces of images
    unless a tensor is off 16-byte alignment; the grid fills at least
    half of the card's window-route residency."""
    n, c, h, w = LRN_LAYERS[layer]
    v = 16 // itemsize
    for outer, inner, vec in ((n, h * w, 1), (h * w, n, v)):
        plan = lrn.bwd_plan(outer, c, inner, 5, itemsize)
        assert plan.route == "window" and plan.vec == vec
        assert plan.chunk >= 4 * (5 - 1) or plan.chunk == c
        groups = outer * inner // vec
        nchunks = -(-c // plan.chunk)
        assert plan.blocks == -(-groups // plan.threads) * nchunks
        assert groups * nchunks >= 132 * lrn._RESIDENT[vec] // 2
        assert lrn.bwd_plan(outer, c, inner, 5, itemsize,
                            aligned=False).vec == 1


def _lrn_window_walk(c, nsize, chunk):
    """The window route's schedule (csrc/lrn.cu lrn_bwd_window_kernel)
    over one column, on channel indices: for each channel written, the
    channels its norm and inner windows summed (ascending), and the
    channels each chunk's walk loaded.  None stands for a zero (a channel
    outside [0, c))."""
    lo, hi, ahead = nsize // 2, nsize - 1 - nsize // 2, 2
    ok = lambda j: j if 0 <= j < c else None  # noqa: E731
    norms, inners, written, loads = {}, {}, [], []
    for c0 in range(0, c, chunk):
        c1 = min(c, c0 + chunk)
        xend, gend = min(c, c1 + nsize - 1), min(c, c1 + lo)
        okx = lambda j: j if 0 <= j < xend else None  # noqa: E731
        okg = lambda j: j if 0 <= j < gend else None  # noqa: E731
        xr = [None] + [ok(c0 - nsize + j) for j in range(1, nsize)]
        inn = [None] * nsize
        gp = [None] * (lo + 1)
        qx = [okx(c0 + j) for j in range(ahead)]
        qg = [okg(c0 + j - hi) for j in range(ahead)]
        xs, gs = [j for j in xr if j is not None], []
        xs += [j for j in qx if j is not None]
        gs += [j for j in qg if j is not None]
        norm_of = {}
        for s in range(c1 - c0 + nsize - 1):
            t = c0 + s
            a = t - hi
            xn, gn = qx.pop(0), qg.pop(0)
            qx.append(okx(t + ahead))
            qg.append(okg(t + ahead - hi))
            xs += [j for j in qx[-1:] if j is not None]
            gs += [j for j in qg[-1:] if j is not None]
            xr = xr[1:] + [xn]
            assert xr[lo] == ok(a)
            assert gn == ok(a) or a >= c1 + lo
            norm_of[a] = [j for j in xr if j is not None]
            inn = inn[1:] + [gn]
            gp = gp[1:] + [a]
            if s >= nsize - 1:
                ch = t - nsize + 1
                assert xr[0] == ch and gp[0] == ch
                written.append(ch)
                norms[ch] = norm_of[ch]
                inners[ch] = [j for j in inn if j is not None]
        loads.append((xs, gs))
    return norms, inners, written, loads


def _chwin_members(c, nsize, transpose):
    """The channels lrn.chwin_sum adds into each channel, from its one-hot
    image (sp[:, 0:c] + sp[:, 1:c + 1] + ..., the lowest channel
    first)."""
    eye = torch.eye(c, dtype=torch.float64).reshape(1, c, c)
    mask = lrn.chwin_sum(eye, nsize, transpose)[0].tolist()
    return {j: [i for i in range(c) if mask[j][i] != 0] for j in range(c)}


@pytest.mark.parametrize("nsize", range(1, 13))
def test_lrn_bwd_window_walk_sums_chwin_windows(nsize):
    """At every chunking of C up to 40, the window route's walk writes
    each channel once, sums its norm over chwin_sum's forward window and
    its inner values over the transposed window, both from the lowest
    channel up, and loads each x and g channel of its chunk and halo
    once."""
    for c in range(1, 41):
        fwd = _chwin_members(c, nsize, False)
        bwd = _chwin_members(c, nsize, True)
        for chunk in sorted({1, 2, 3, nsize, 7, 16, c}):
            if chunk > c:
                continue
            norms, inners, written, loads = _lrn_window_walk(c, nsize, chunk)
            assert written == list(range(c))
            for j in range(c):
                assert norms[j] == fwd[j], (c, chunk, j)
                assert inners[j] == bwd[j], (c, chunk, j)
            for k, (xs, gs) in enumerate(loads):
                c0, c1 = k * chunk, min(c, (k + 1) * chunk)
                lo, hi = nsize // 2, nsize - 1 - nsize // 2
                assert xs == list(range(max(0, c0 - nsize + 1),
                                        min(c, c1 + nsize - 1)))
                assert gs == list(range(max(0, c0 - hi), min(c, c1 + lo)))


@pytest.mark.parametrize("nsize", [1, 2, 3, 4, 5, 7, 9, 33, 64, 1000])
def test_lrn_fwd_plan_takes_every_window(nsize):
    """Every window n >= 1 at every C and column count has a forward
    route: the window route at the compiled windows, whose chunks cover
    every channel once, else the recompute route (one thread a column,
    every channel)."""
    for c in range(1, 301):
        for outer, inner in ((1, 1), (3, 5), (256, 729), (169, 256)):
            for aligned in (False, True):
                plan = lrn.fwd_plan(outer, c, inner, nsize, 2, aligned)
                if nsize in lrn.WINDOW_SIZES:
                    assert plan.route == "window" and plan.smem == 0
                    nchunks = -(-c // plan.chunk)
                    starts = range(0, c, plan.chunk)
                    covered = [j for c0 in starts
                               for j in range(c0, min(c, c0 + plan.chunk))]
                    assert covered == list(range(c))
                    assert (nchunks - 1) * plan.chunk < c
                    groups = outer * inner // plan.vec
                    assert plan.vec in (1, 8)
                    assert plan.vec == 1 or (aligned and inner % 8 == 0)
                    assert plan.blocks == -(-groups // plan.threads) * nchunks
                else:
                    assert plan.route == "recompute" and plan.chunk == c
                    assert plan.blocks == -(-outer * inner // plan.threads)


@pytest.mark.parametrize("layer", sorted(LRN_LAYERS))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_lrn_fwd_plan_fast_route_at_alexnets_layers(layer, itemsize):
    """Both views of lrn1 and lrn2 take the forward's window route: NCHW
    a column a thread, (H, W, C, N) 16-byte pieces of images unless a
    tensor is off 16-byte alignment; the grid fills two waves of the
    card's window-route residency, or C is cut into the most chunks of
    4 (n - 1) channels or more; every view of both layers runs in
    chunks."""
    n, c, h, w = LRN_LAYERS[layer]
    v = 16 // itemsize
    for outer, inner, vec in ((n, h * w, 1), (h * w, n, v)):
        plan = lrn.fwd_plan(outer, c, inner, 5, itemsize)
        assert plan.route == "window" and plan.vec == vec
        assert 4 * (5 - 1) <= plan.chunk < c
        groups = outer * inner // vec
        nchunks = -(-c // plan.chunk)
        assert plan.blocks == -(-groups // plan.threads) * nchunks
        assert (groups * nchunks >= 2 * 132 * lrn._FWD_RESIDENT[vec]
                or nchunks >= c // (4 * (5 - 1)))
        assert lrn.fwd_plan(outer, c, inner, 5, itemsize,
                            aligned=False).vec == 1


def _lrn_fwd_window_walk(c, nsize, chunk, ahead=4):
    """The forward's window route (csrc/lrn.cu lrn_fwd_window_kernel) over
    one column, on channel indices: for each channel written, the
    channels its norm summed (ascending), and the channels each chunk's
    walk loaded.  None stands for a zero (a channel outside the walk)."""
    lo, hi = nsize // 2, nsize - 1 - nsize // 2
    ok = lambda j: j if 0 <= j < c else None  # noqa: E731
    norms, written, loads = {}, [], []
    for c0 in range(0, c, chunk):
        c1 = min(c, c0 + chunk)
        xend = min(c, c1 + hi)
        okx = lambda j: j if 0 <= j < xend else None  # noqa: E731
        xr = [None] + [okx(c0 - lo - 1 + j) for j in range(1, nsize)]
        t0 = c0 + hi
        qx = [okx(t0 + j) for j in range(ahead)]
        xs = [j for j in xr + qx if j is not None]
        for s in range(c1 - c0):
            t = t0 + s
            xn = qx.pop(0)
            qx.append(okx(t + ahead))
            xs += [j for j in qx[-1:] if j is not None]
            xr = xr[1:] + [xn]
            a = t - hi
            assert xr[lo] == ok(a)
            written.append(a)
            norms[a] = [j for j in xr if j is not None]
        loads.append(xs)
    return norms, written, loads


@pytest.mark.parametrize("nsize", range(1, 13))
@pytest.mark.parametrize("ahead", [4, 8])
def test_lrn_fwd_window_walk_sums_chwin_windows(nsize, ahead):
    """At every chunking of C up to 40, the forward's window walk writes
    each channel once, sums its norm over chwin_sum's window from the
    lowest channel up, and loads each x channel of its chunk and halo
    once."""
    for c in range(1, 41):
        fwd = _chwin_members(c, nsize, False)
        for chunk in sorted({1, 2, 3, nsize, 7, 16, c}):
            if chunk > c:
                continue
            norms, written, loads = _lrn_fwd_window_walk(c, nsize, chunk,
                                                         ahead)
            assert written == list(range(c))
            for j in range(c):
                assert norms[j] == fwd[j], (c, chunk, j)
            lo, hi = nsize // 2, nsize - 1 - nsize // 2
            for k, xs in enumerate(loads):
                c0, c1 = k * chunk, min(c, (k + 1) * chunk)
                assert xs == list(range(max(0, c0 - lo), min(c, c1 + hi)))


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


@pytest.mark.parametrize("shape,geom,route", POOL_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_max_pool_fwd_plan_covers_every_output_once(shape, geom, route,
                                                    itemsize):
    """The forward's cells route where the backward's is (the same
    windows, a plane's x and y within the forward's budget): the groups
    tile the planes, a thread each output column of each plane of its
    group, and the block's shared memory holds the group's x and y after
    a shift of up to one 16-byte piece each."""
    n, c, h, w = shape
    planes = n * c
    kh, kw, s, py, px = geom
    oh = pool.pool_out_size_padded(h, kh, s, py)
    ow = pool.pool_out_size_padded(w, kw, s, px)
    plan = pool.fwd_plan(planes, h, w, geom, itemsize)
    assert plan.route == ("cells" if route == "cells" else "per-output")
    assert pool.fwd_plan(planes, h, w, geom, itemsize,
                         aligned=False).route == "per-output"
    if plan.route != "cells":
        return
    assert plan.cells == ow and plan.group * ow <= pool._CELL_THREADS
    groups = [range(b * plan.group, min(planes, (b + 1) * plan.group))
              for b in range(plan.blocks)]
    assert all(groups)
    assert sorted(p for g in groups for p in g) == list(range(planes))
    v = 16 // itemsize
    assert plan.smem % 16 == 0 and plan.smem <= pool.FWD_SMEM <= 232448
    assert plan.smem >= ((plan.group * h * w + v - 1)
                         + (plan.group * oh * ow + v - 1)) * itemsize


def _fwd_cells_reads(ox, geom, h, w, oh):
    """The forward's cells walk (csrc/max_pool.cu mp_fwd_cells_walk) down
    output column ox: the input rows each output row's max covers (its
    K-row register window) and every row the walk reads, in order."""
    kh, kw, s, py, px = geom
    rows_read = []

    def row(iy):
        if 0 <= iy < h:
            rows_read.append(iy)
            return {iy}
        return set()

    rm = [row(k - py) for k in range(kh)]
    covered = []
    for oy in range(oh):
        covered.append(set().union(*rm))
        if oy + 1 == oh:
            break
        rm = [rm[k + s] if k + s < kh else row((oy + 1) * s - py + k)
              for k in range(kh)]
    cols = [ox * s - px + j for j in range(kw) if 0 <= ox * s - px + j < w]
    return covered, cols, rows_read


@pytest.mark.parametrize("shape,geom,route", POOL_SHAPES[:6])
def test_max_pool_fwd_cells_walk_reads_the_clipped_window(shape, geom,
                                                          route):
    """Every output's register window covers exactly the input rows and
    columns of its window clipped to the input, and a thread reads each
    input row of its walk from shared memory once."""
    n, c, h, w = shape
    kh, kw, s, py, px = geom
    oh = pool.pool_out_size_padded(h, kh, s, py)
    ow = pool.pool_out_size_padded(w, kw, s, px)
    for ox in range(ow):
        covered, cols, rows_read = _fwd_cells_reads(ox, geom, h, w, oh)
        assert len(rows_read) == len(set(rows_read))
        assert cols == [ix for ix in range(ox * s - px, ox * s - px + kw)
                        if 0 <= ix < w] and cols
        for oy in range(oh):
            want = {iy for iy in range(oy * s - py, oy * s - py + kh)
                    if 0 <= iy < h}
            assert covered[oy] == want and want, (ox, oy)


def test_max_pool_fwd_plan_fast_route_at_cnn_pools():
    """AlexNet's three pools and MNIST_CONV's take the cells route, with
    no more planes a block than leave the card's 132 SMs two blocks each
    (MNIST's 3200 planes: 13 a block, 247 blocks) and each SM able to
    hold two blocks; pool1 in bf16 stages 8 planes a block (27 columns
    each, 216 threads) in 59 KB."""
    geom = (3, 3, 2, 0, 0)
    for (n, c, h, w), ow in (((256, 96, 55, 55), 27),
                             ((256, 256, 27, 27), 13),
                             ((256, 256, 13, 13), 6),
                             ((100, 32, 14, 14), 7)):
        for itemsize in (2, 4):
            plan = pool.fwd_plan(n * c, h, w, geom, itemsize)
            assert plan.route == "cells" and plan.cells == ow
            assert plan.group <= -(-n * c // (2 * 132))
            assert 2 * plan.smem <= 232448
    assert pool.fwd_plan(256 * 96, 55, 55, geom, 2) == pool.FwdPlan(
        "cells", 27, 8, 3072, 60096)

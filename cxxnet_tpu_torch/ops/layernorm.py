"""Row LayerNorm: the hand-written CUDA kernels (``csrc/layernorm_fwd.cu``,
``csrc/layernorm_bwd.cu``), their plain PyTorch versions and the
autograd Function that ties them together.

Replaces the JAX package's Pallas ``layernorm_pallas`` (``_ln_fwd_res``
/ ``_ln_bwd_res``, pallas_kernels.py): ``(rows, d)`` input, ``(d,)``
gamma / beta, two-pass float32 variance; the forward returns ``y`` in
x's dtype and ``mean`` / ``rstd`` as ``(rows, 1)`` float32.  The
backward has the JAX package's two residual contracts: by default it
rebuilds xhat from the output (residuals ``y, gamma, beta, rstd``; no
``(rows, d)`` buffer beyond the output), and with ``save_x`` (config
``pallas_ln = x``) from the saved input (``x, gamma, mean, rstd``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import build

#: largest row the forward's block route keeps in shared memory (float32)
MAX_D = (232448 - 256) // 4
#: widest row of the forward's warp route (csrc/layernorm_fwd.cu LNW_MAX_D)
WARP_MAX_D = 4096
#: the forward kernels (csrc/layernorm_fwd.cu cxn_layernorm_fwd_route): a
#: warp per row in registers, or a block per row through shared memory
ROUTES = ("warp", "block")
#: the backward's routes (csrc/layernorm_bwd.cu), chosen by :func:`bwd_plan`:
#: rows in registers, 1-8 warps a row, up to BWD_REG_MAX_D; or, wider, a
#: block per row for the row sums and then column strips streamed again
BWD_ROUTES = ("register", "stream")
BWD_REG_MAX_D = 4096
#: threads of a backward block; register-route blocks resident on an SM
#: (the kernel's __launch_bounds__) for 8 and 16 columns a thread
_BWD_THREADS = 256
_BWD_PER_SM = {8: 3, 16: 2}
#: stream route: column-strip blocks aimed at per SM
_BWD_STRIPS_PER_SM = 8


class BwdPlan(NamedTuple):
    """How the backward kernel covers a (rows, d) problem."""
    route: str      # one of BWD_ROUTES
    vec: bool       # 16-byte row loads (else scalar ones)
    el: int         # register route: columns a thread holds (8 or 16)
    warps: int      # register route: warps a row (1, 2, 4 or 8)
    blocks: int     # register route: the grid; stream route: row runs
    parts: int      # rows of the (parts, d) float32 column partials


def bwd_route(d: int) -> str:
    """The backward route a row of width ``d`` takes."""
    return BWD_ROUTES[0] if d <= BWD_REG_MAX_D else BWD_ROUTES[1]


def bwd_plan(rows: int, d: int, itemsize: int, aligned: bool = True,
             sms: int = 132) -> BwdPlan:
    """The backward's launch plan for (rows, d) rows of ``itemsize``-byte
    elements on a card of ``sms`` SMs; ``aligned``: y (or x), dy and dx
    start on 16-byte boundaries.  Register route: a row slot of the
    persistent grid visits rows slot, slot + slots, ..; stream route:
    run k holds rows [k per, (k + 1) per), per = ceil(rows / blocks)."""
    vec_el = 16 // itemsize
    vec = aligned and d % vec_el == 0
    if bwd_route(d) == "register":
        el = 8 if d <= 8 * _BWD_THREADS else 16
        warps = 1
        while 32 * warps * el < d:
            warps *= 2
        slots = _BWD_THREADS // 32 // warps
        blocks = min(-(-rows // slots), sms * _BWD_PER_SM[el])
        return BwdPlan("register", vec, el, warps, blocks, blocks * slots)
    strips = -(-d // (_BWD_THREADS * (vec_el if vec else 1)))
    runs = min(rows, max(1, -(-sms * _BWD_STRIPS_PER_SM // strips)))
    runs = -(-rows // -(-rows // runs))   # no empty run
    return BwdPlan("stream", vec, 0, 0, runs, runs)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.dtype == torch.float64 else t.float()


def layernorm_fwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (two-pass float32 moments)."""
    x32 = _acc(x)
    mean = x32.mean(dim=1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd * _acc(gamma) + _acc(beta)
    return y.to(x.dtype), mean, rstd


def layernorm_bwd_plain(dy: torch.Tensor, a: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor,
                        save_x: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)`` in plain PyTorch.  ``a`` is the output y
    (``save_x`` false: xhat = (y - beta) / gamma, 0 where gamma == 0;
    ``mean`` unused) or the input x (``save_x`` true: xhat =
    (x - mean) * rstd; ``beta`` unused)."""
    a32, dy32, g = _acc(a), _acc(dy), _acc(gamma)
    if save_x:
        xhat = (a32 - mean) * rstd
    else:
        zero = g == 0.0
        xhat = torch.where(zero, 0.0,
                           (a32 - _acc(beta)) / torch.where(zero, 1.0, g))
    dyg = dy32 * g
    c1 = dyg.mean(dim=1, keepdim=True)
    c2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (dyg - c1 - xhat * c2)
    dg = (dy32 * xhat).sum(dim=0)
    db = dy32.sum(dim=0)
    return dx.to(a.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


def kernel_route(d: int) -> str:
    """The forward kernel a row of width ``d`` takes, as the C dispatcher
    decides it (builds the library)."""
    return ROUTES[build.LIBRARY.get().cxn_layernorm_fwd_route(int(d))]


def _check_vecs(what: str, x: torch.Tensor, *vecs: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (rows, d), got {tuple(x.shape)}")
    d = x.shape[1]
    if any(tuple(t.shape) != (d,) for t in vecs):
        raise ValueError(f"{what}: gamma / beta "
                         f"{[tuple(t.shape) for t in vecs]} do not match "
                         f"d = {d}")
    if x.dtype not in build.DTYPE_CODES or any(t.dtype != vecs[0].dtype
                                               for t in vecs) \
            or vecs[0].dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtypes x {x.dtype}, gamma / beta "
                         f"{[t.dtype for t in vecs]}: expected float32 or "
                         "bfloat16, gamma and beta alike")
    if not all(t.is_contiguous() for t in (x,) + vecs):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.device != x.device for t in vecs):
        raise ValueError(f"{what}: inputs on different devices")


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)`` for ``(rows, d)`` x.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`layernorm_fwd_plain`."""
    if x.device.type in build.PLAIN_DEVICES:
        return layernorm_fwd_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_fwd: no kernel for {x.device}")
    _check_vecs("layernorm_fwd", x, gamma, beta)
    rows, d = x.shape
    if not 1 <= d <= MAX_D or rows < 1:
        raise ValueError(f"layernorm_fwd: shape {tuple(x.shape)} out of "
                         f"range (d up to {MAX_D})")
    lib = build.LIBRARY.get()
    y = torch.empty_like(x)
    # mean and rstd: two contiguous halves of one allocation
    mean, rstd = torch.empty((2, rows, 1), dtype=torch.float32,
                             device=x.device)
    err = lib.cxn_layernorm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[gamma.dtype],
        build.stream_handle(x.device))
    build.check(err, "layernorm_fwd")
    layernorm_fwd.launches += 1
    return y, mean, rstd


def layernorm_bwd(dy: torch.Tensor, a: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                  save_x: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)`` (see :func:`layernorm_bwd_plain` for the
    arguments).  A CUDA tensor goes through the CUDA kernel (or raises);
    a CPU tensor through the plain version."""
    if a.device.type in build.PLAIN_DEVICES:
        return layernorm_bwd_plain(dy, a, gamma, beta, mean, rstd, save_x)
    if a.device.type != "cuda":
        raise ValueError(f"layernorm_bwd: no kernel for {a.device}")
    _check_vecs("layernorm_bwd", a, gamma, beta)
    rows, d = a.shape
    if (dy.shape != a.shape or dy.dtype != a.dtype or not dy.is_contiguous()
            or dy.device != a.device):
        raise ValueError(f"layernorm_bwd: dy {dy.dtype} {tuple(dy.shape)} "
                         f"must be a contiguous {a.dtype} {tuple(a.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (tuple(t.shape) != (rows, 1) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"layernorm_bwd: {name} must be contiguous "
                             f"float32 ({rows}, 1)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"layernorm_bwd: d = {d} out of range (up to "
                         f"{MAX_D})")
    lib = build.LIBRARY.get()
    dx = torch.empty_like(a)
    plan = bwd_plan(rows, d, a.element_size(),
                    all(t.data_ptr() % 16 == 0 for t in (a, dy, dx)),
                    _sm_count(a.device.index or 0))
    # the (parts, d) dgamma and dbeta partials, then the stream route's
    # (rows, 2) row means
    scratch = torch.empty(2 * plan.parts * d + 2 * rows * (
        plan.route == "stream"), dtype=torch.float32, device=a.device)
    dg = torch.empty_like(gamma)
    db = torch.empty_like(gamma)
    err = lib.cxn_layernorm_bwd(
        a.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        dg.data_ptr(), db.data_ptr(), rows, d, BWD_ROUTES.index(plan.route),
        int(plan.vec), plan.el, plan.warps, plan.blocks, int(bool(save_x)),
        build.DTYPE_CODES[a.dtype], build.DTYPE_CODES[gamma.dtype],
        build.stream_handle(a.device))
    build.check(err, "layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, dg, db


#: launches of each CUDA kernel (not of the plain versions)
layernorm_fwd.launches = 0
layernorm_bwd.launches = 0


class LayerNorm(torch.autograd.Function):
    """``y`` of (rows, d) x: forward :func:`layernorm_fwd`, backward
    :func:`layernorm_bwd`.  Residuals: ``(y, gamma, beta, rstd)`` by
    default, never x; ``(x, gamma, mean, rstd)`` with ``save_x``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, save_x: bool):
        y, mean, rstd = layernorm_fwd(x, gamma, beta, eps)
        ctx.save_x = save_x
        if save_x:
            ctx.save_for_backward(x, gamma, beta, mean, rstd)
        else:
            ctx.save_for_backward(y, gamma, beta, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        if ctx.save_x:
            a, gamma, beta, mean, rstd = ctx.saved_tensors
        else:
            a, gamma, beta, rstd = ctx.saved_tensors
            mean = rstd  # unused without save_x; any (rows, 1) float32
        dx, dg, db = layernorm_bwd(dy.contiguous(), a, gamma, beta, mean,
                                   rstd, ctx.save_x)
        return dx, dg, db, None, None


def layernorm(x, gamma, beta, eps: float, save_x: bool = False):
    """Differentiable row layernorm of (rows, d) x."""
    return LayerNorm.apply(x, gamma, beta, eps, save_x)

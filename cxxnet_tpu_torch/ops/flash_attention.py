"""Flash attention: the hand-written CUDA kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``), their plain PyTorch versions and the
autograd Functions that tie a forward to its backward kernel.

Replaces the JAX package's Pallas ``flash_attention`` (``_fa_fwd`` /
``_fa_bwd``) and ``flash_attention_segmented`` (``_fa_seg_fwd`` /
``_fa_seg_bwd``, pallas_kernels.py).  Layout as there: q, k, v are
``(b*h, s, d)``; the forward returns ``o`` in q's dtype and ``lse`` as
``(b*h, 1, s)`` float32; segment ids are ``(b, s)`` integers shared by
the ``h`` heads of a batch entry (0 = padding), with the mask rule
``causal & ((same segment & segment != 0) | diagonal)``.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain version for a CPU tensor.  The kernels take head widths that
are multiples of 8 up to 256; :func:`flash_attention` and
:func:`flash_attention_segmented` widen any other width up to 256 with
zero columns.  :func:`attention_route` sends what the JAX package's
``_single_device_attention`` runs densely (heads wider than 256,
non-causal attention with segment ids) to plain dense attention,
before any launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.ring import NEG_INF
from . import build

#: widest head the kernels take (the JAX package's
#: ``flash_attention_available`` bound too)
MAX_D = 256
#: float elements of one score matrix chunk in the plain versions
_PLAIN_CHUNK_ELEMS = 1 << 26


def flash_attention_supported(d: int) -> bool:
    """Head widths the kernels take unwidened (any sequence length does)."""
    return d % 8 == 0 and 8 <= d <= MAX_D


def dense_reason(hd: int, causal: bool, has_seg: bool) -> Optional[str]:
    """Why an attention call at head width ``hd`` takes plain dense
    attention, as the JAX package's ``_single_device_attention`` does,
    or None when a flash kernel takes it.  Decided from shapes alone,
    the same on every device."""
    if has_seg and not causal:
        return "non-causal attention with segment ids (the segmented " \
               "kernels are causal)"
    if hd > MAX_D:
        return f"head width {hd} above {MAX_D}"
    return None


def attention_route(hd: int, causal: bool, has_seg: bool) -> str:
    """``"flash_seg"`` (segment ids, causal), ``"flash"`` or ``"dense"``
    (see :func:`dense_reason`) for one attention call."""
    if dense_reason(hd, causal, has_seg) is not None:
        return "dense"
    return "flash_seg" if has_seg else "flash"


#: the kernels a bf16 or float32 call can take, indexed by the C enum
#: (csrc/flash_common.cuh FaRoute): float32 on the CUDA cores, bf16
#: (forward and backward, every head width) through wgmma
ROUTES = ("simt", "wgmma")


def kernel_route(d: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The CUDA kernel a forward (or backward) call at head width ``d`` in
    ``dtype`` launches, as the C dispatcher decides it (builds the
    library)."""
    code = build.LIBRARY.get().cxn_flash_attn_route(
        int(d), build.DTYPE_CODES[dtype], int(bool(backward)))
    if code < 0:
        raise ValueError(f"no flash {'backward' if backward else 'forward'} "
                         f"kernel for head width {d} in {dtype}")
    return ROUTES[code]


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


# ------------------------------------------------------------------ plain
def _acc(t: torch.Tensor) -> torch.Tensor:
    """float32 arithmetic (bf16 values are exact in it); float64 stays
    float64, for gradcheck."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _seg_rows(seg: Optional[torch.Tensor], bh: int) -> Optional[torch.Tensor]:
    """(b, s) segment ids -> (b*h, s), b-major like ``q.reshape(b*h, ...)``."""
    if seg is None:
        return None
    b = seg.shape[0]
    if seg.dim() != 2 or bh % b != 0:
        raise ValueError(f"segment ids {tuple(seg.shape)}: expected (b, s) "
                         f"with b dividing b*h = {bh}")
    return seg.repeat_interleave(bh // b, dim=0)


def _scores(q, k, scale: float, causal: bool,
            seg: Optional[torch.Tensor]) -> torch.Tensor:
    """(n, s, d) x (n, s, d) -> (n, s, s) masked scores, NEG_INF where
    masked (``_causal_mask`` then ``_segment_mask``)."""
    s = torch.matmul(_acc(q), _acc(k).transpose(1, 2)) * scale
    s_len = q.shape[1]
    pos = torch.arange(s_len, device=q.device)
    allowed = None
    if causal:
        allowed = (pos[:, None] >= pos[None, :])[None]
    if seg is not None:
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        live = same | (pos[:, None] == pos[None, :])[None]
        allowed = live if allowed is None else allowed & live
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    return s


def _chunks(bh: int, s_len: int, device: torch.device):
    """b*h slices that bound each plain score matrix to ~256 MB; one
    slice on ``meta``, which holds no storage (a traced graph stays
    short)."""
    if device.type == "meta":
        return [slice(0, bh)]
    step = max(1, _PLAIN_CHUNK_ELEMS // (s_len * s_len))
    return [slice(i, min(i + step, bh)) for i in range(0, bh, step)]


def _fwd_plain(q, k, v, causal, scale, seg):
    """The forward over the whole score matrix: scores times ``scale``,
    masked, ``p`` cast to v's dtype before ``p·V`` with float32 sums,
    ``o`` in q's dtype and ``lse = m + log(l)``."""
    scale = _default_scale(q, scale)
    segr = _seg_rows(seg, q.shape[0])
    os_, lses = [], []
    for sl in _chunks(q.shape[0], q.shape[1], q.device):
        s = _scores(q[sl], k[sl], scale, causal,
                    None if segr is None else segr[sl])
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(_acc(p.to(v.dtype)), _acc(v[sl])) / l
        os_.append(o.to(q.dtype))
        lses.append((m + torch.log(l)).transpose(1, 2))
    return torch.cat(os_), torch.cat(lses)


def _bwd_plain(q, k, v, o, lse, do, causal, scale, seg):
    """``_fa_p_ds`` and the three products over the whole score matrix:
    p cast to the input dtype before ``dv = pᵀ·dO``, ds before
    ``dk = dsᵀ·q`` and ``dq = ds·k``; float32 sums; outputs in the input
    dtype."""
    scale = _default_scale(q, scale)
    segr = _seg_rows(seg, q.shape[0])
    dqs, dks, dvs = [], [], []
    for sl in _chunks(q.shape[0], q.shape[1], q.device):
        s = _scores(q[sl], k[sl], scale, causal,
                    None if segr is None else segr[sl])
        p = torch.exp(s - _acc(lse[sl]).transpose(1, 2))
        g = _acc(do[sl])
        dp = torch.matmul(g, _acc(v[sl]).transpose(1, 2))
        delta = (g * _acc(o[sl])).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dvs.append(torch.matmul(_acc(p.to(do.dtype)).transpose(1, 2), g)
                   .to(v.dtype))
        dks.append(torch.matmul(_acc(ds.to(q.dtype)).transpose(1, 2),
                                _acc(q[sl])).to(k.dtype))
        dqs.append(torch.matmul(_acc(ds.to(k.dtype)), _acc(k[sl]))
                   .to(q.dtype))
    return torch.cat(dqs), torch.cat(dks), torch.cat(dvs)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` in plain PyTorch (see :func:`_fwd_plain`)."""
    return _fwd_plain(q, k, v, causal, scale, None)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              scale: Optional[float] = None):
    """``(dq, dk, dv)`` in plain PyTorch (see :func:`_bwd_plain`)."""
    return _bwd_plain(q, k, v, o, lse, do, causal, scale, None)


def flash_attention_seg_fwd_plain(q, k, v, seg, scale: Optional[float] = None):
    """The segmented (always causal) forward in plain PyTorch."""
    return _fwd_plain(q, k, v, True, scale, seg)


def flash_attention_seg_bwd_plain(q, k, v, seg, o, lse, do,
                                  scale: Optional[float] = None):
    """The segmented backward in plain PyTorch; seg gets no gradient."""
    return _bwd_plain(q, k, v, o, lse, do, True, scale, seg)


# ---------------------------------------------------------------- kernels
def _check(what: str, tensors, d_max: int) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{what}: expected equal (b*h, s, d) shapes, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    d = q.shape[2]
    if not (d % 8 == 0 and 8 <= d <= d_max):
        raise ValueError(f"{what}: head width {d} is not a multiple of 8 "
                         f"in 8..{d_max}")
    if q.dtype not in build.DTYPE_CODES or any(t.dtype != q.dtype
                                               for t in tensors):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in tensors]}: "
                         "expected one of float32, bfloat16, the same for "
                         "every input")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: inputs on different devices")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: bf16 inputs must be 16-byte aligned (the "
                         "kernel reads 16-byte rows)")


def _check_lse(what: str, lse: torch.Tensor, q: torch.Tensor) -> None:
    want = (q.shape[0], 1, q.shape[1])
    if (tuple(lse.shape) != want or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"{what}: lse must be contiguous float32 {want} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")


def _seg_int32(what: str, seg: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A contiguous int32 (b, s) copy of the segment ids, checked."""
    bh, s_len = q.shape[0], q.shape[1]
    if (seg.dim() != 2 or seg.shape[1] != s_len or seg.shape[0] < 1
            or bh % seg.shape[0] != 0):
        raise ValueError(f"{what}: segment ids {tuple(seg.shape)}: expected "
                         f"(b, {s_len}) with b dividing b*h = {bh}")
    if seg.dtype.is_floating_point or seg.dtype == torch.bool:
        raise ValueError(f"{what}: segment ids must be integers, got "
                         f"{seg.dtype}")
    return seg.to(device=q.device, dtype=torch.int32).contiguous()


def _launch_fwd(what, q, k, v, seg32, causal, scale):
    bh, s_len, d = q.shape
    lib = build.LIBRARY.get()
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, s_len), dtype=torch.float32, device=q.device)
    h = 1 if seg32 is None else bh // seg32.shape[0]
    err = lib.cxn_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if seg32 is None else seg32.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, s_len, d, int(bool(causal)), float(scale),
        build.DTYPE_CODES[q.dtype], build.stream_handle(q.device))
    build.check(err, what)
    return o, lse


def _launch_bwd(what, q, k, v, seg32, o, lse, do, causal, scale):
    bh, s_len, d = q.shape
    lib = build.LIBRARY.get()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((bh, s_len), dtype=torch.float32, device=q.device)
    h = 1 if seg32 is None else bh // seg32.shape[0]
    err = lib.cxn_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if seg32 is None else seg32.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, h, s_len, d, int(bool(causal)),
        float(scale), build.DTYPE_CODES[q.dtype],
        build.stream_handle(q.device))
    build.check(err, what)
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` for ``(b*h, s, d)`` q/k/v: the CUDA kernel for a CUDA
    tensor (or a raise), :func:`flash_attention_fwd_plain` on the CPU."""
    scale = _default_scale(q, scale)
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check("flash_attention_fwd", (q, k, v), MAX_D)
    out = _launch_fwd("flash_attention_fwd", q, k, v, None, causal, scale)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` and the
    output gradient ``do``: the CUDA kernel for a CUDA tensor (or a
    raise), :func:`flash_attention_bwd_plain` on the CPU."""
    scale = _default_scale(q, scale)
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    _check("flash_attention_bwd", (q, k, v, o, do), MAX_D)
    _check_lse("flash_attention_bwd", lse, q)
    out = _launch_bwd("flash_attention_bwd", q, k, v, None, o, lse, do,
                      causal, scale)
    flash_attention_bwd.launches += 1
    return out


def flash_attention_seg_fwd(q, k, v, seg, scale: Optional[float] = None):
    """Segment-masked causal ``(o, lse)``; ``seg`` is ``(b, s)`` integer
    ids.  The CUDA kernel for a CUDA tensor (or a raise),
    :func:`flash_attention_seg_fwd_plain` on the CPU."""
    scale = _default_scale(q, scale)
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_seg_fwd_plain(q, k, v, seg, scale)
    _check("flash_attention_seg_fwd", (q, k, v), MAX_D)
    seg32 = _seg_int32("flash_attention_seg_fwd", seg, q)
    out = _launch_fwd("flash_attention_seg_fwd", q, k, v, seg32, True, scale)
    flash_attention_seg_fwd.launches += 1
    return out


def flash_attention_seg_bwd(q, k, v, seg, o, lse, do,
                            scale: Optional[float] = None):
    """The segmented backward ``(dq, dk, dv)``: the CUDA kernel for a
    CUDA tensor (or a raise), :func:`flash_attention_seg_bwd_plain` on
    the CPU."""
    scale = _default_scale(q, scale)
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_seg_bwd_plain(q, k, v, seg, o, lse, do, scale)
    _check("flash_attention_seg_bwd", (q, k, v, o, do), MAX_D)
    _check_lse("flash_attention_seg_bwd", lse, q)
    seg32 = _seg_int32("flash_attention_seg_bwd", seg, q)
    out = _launch_bwd("flash_attention_seg_bwd", q, k, v, seg32, o, lse, do,
                      True, scale)
    flash_attention_seg_bwd.launches += 1
    return out


#: launches of each CUDA kernel (not of the plain versions)
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_seg_fwd.launches = 0
flash_attention_seg_bwd.launches = 0


# --------------------------------------------------------------- autograd
class FlashAttention(torch.autograd.Function):
    """``o`` of (b*h, s, d) q/k/v: forward :func:`flash_attention_fwd`,
    backward :func:`flash_attention_bwd` from the saved q, k, v, o, lse
    (the JAX package's ``flash_attention`` custom vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class FlashAttentionSegmented(torch.autograd.Function):
    """Segment-masked causal ``o``: forward :func:`flash_attention_seg_fwd`,
    backward :func:`flash_attention_seg_bwd`; the segment ids get no
    gradient (the JAX package's ``flash_attention_segmented``)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale: float):
        o, lse = flash_attention_seg_fwd(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_seg_bwd(q, k, v, seg, o, lse,
                                             do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def _widen(q, k, v):
    """q, k, v with zero columns up to the next multiple of 8 (at least
    8), and the true width.  Exact: zero columns add nothing to q·k or
    to p·V, and the gradients of the output's cut-off columns are 0."""
    d = q.shape[-1]
    pad = max(8, d + (-d) % 8) - d
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    return q, k, v, d


def flash_attention(q, k, v, causal: bool, scale: Optional[float] = None):
    """Differentiable flash attention over (b*h, s, d) q/k/v; a head
    width off the kernels' multiples of 8 runs widened (:func:`_widen`)
    at its own scale, the output cut back to it."""
    scale = _default_scale(q, scale)
    q, k, v, d = _widen(q, k, v)
    return FlashAttention.apply(q, k, v, causal, scale)[..., :d]


def flash_attention_segmented(q, k, v, seg, scale: Optional[float] = None):
    """Differentiable segment-masked causal flash attention; ``seg`` is
    ``(b, s)`` integer segment ids.  Widths as :func:`flash_attention`."""
    scale = _default_scale(q, scale)
    q, k, v, d = _widen(q, k, v)
    return FlashAttentionSegmented.apply(q, k, v, seg, scale)[..., :d]

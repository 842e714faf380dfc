"""Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_attn_fwd.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``_fa_fwd`` (pallas_kernels.py), the
forward half of ``flash_attention``.  Layout as there: q, k, v are
``(b*h, s, d)``; the result is ``o`` in q's dtype and ``lse`` as
``(b*h, 1, s)`` float32.  Forward only: the backward kernels come with
the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.ring import NEG_INF
from . import build


def flash_attention_supported(d: int) -> bool:
    """Head widths the kernel takes (any sequence length does)."""
    return d % 8 == 0 and 8 <= d <= 256


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, over the whole score matrix:
    float32 scores times ``scale``, the causal mask writing ``NEG_INF``,
    ``p`` cast to v's dtype before ``p·V`` with float32 sums, ``o`` in
    q's dtype and ``lse = m + log(l)``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s_len = q.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        pos = torch.arange(s_len, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).transpose(1, 2)
    return o.to(q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` for ``(b*h, s, d)`` q/k/v.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`flash_attention_fwd_plain`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    bh, s_len, d = q.shape
    if not (k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"flash_attention_fwd: q/k/v shapes differ: "
                         f"{q.shape} {k.shape} {v.shape}")
    if not flash_attention_supported(d):
        raise ValueError(f"flash_attention_fwd: head width {d} is not a "
                         "multiple of 8 in 8..256")
    if q.dtype not in build.DTYPE_CODES or not (k.dtype == v.dtype
                                                 == q.dtype):
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype} "
                         f"{k.dtype} {v.dtype}: expected one of float32, "
                         "bfloat16, the same for q, k and v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: bf16 q, k, v must be "
                         "16-byte aligned (the kernel reads 16-byte rows)")
    lib = build.LIBRARY.get()
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, s_len), dtype=torch.float32, device=q.device)
    err = lib.cxn_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s_len, d, int(bool(causal)), float(scale),
        build.DTYPE_CODES[q.dtype], build.stream_handle(q.device))
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


#: launches of the CUDA kernel (not of the plain version)
flash_attention_fwd.launches = 0

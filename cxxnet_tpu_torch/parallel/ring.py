"""Plain attention: the JAX package's single-device oracle
(``cxxnet_tpu/parallel/ring.py`` ``dense_attention`` / ``_block_scores``).

The mask rule for packed documents (``seg``, 0 = padding) is the JAX
package's::

    allowed(iq, jk) = causal(iq >= jk)
                      & ((seg_q == seg_k & seg_q != 0) | iq == jk)

Masked scores get ``NEG_INF`` (a large negative, not ``-inf``, so exp
and where stay NaN-free).  Ring attention over a ``seq`` mesh axis
comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

CHUNKED_ATTN_THRESHOLD = 2048  # above this seq len, never materialize s x s


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 products and sums, whatever the input dtype
    (the JAX side's ``preferred_element_type=float32``: bf16 values are
    exact in float32)."""
    return torch.matmul(a.float(), b.float())


def _block_scores(q, k, scale: float, q_off: int, k_off: int, causal: bool,
                  seg_q: Optional[torch.Tensor] = None,
                  seg_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b,h,sq,d) x (b,h,sk,d) -> (b,h,sq,sk) float32 masked scores."""
    s = _f32_matmul(q, k.transpose(-1, -2)) * scale
    qpos = q_off + torch.arange(q.shape[2], device=q.device)
    kpos = k_off + torch.arange(k.shape[2], device=q.device)
    diag = qpos[:, None] == kpos[None, :]
    if seg_q is not None:
        same = (seg_q[:, :, None] == seg_k[:, None, :]) \
            & (seg_q[:, :, None] != 0)
        allowed = same | diag[None]
        if causal:
            allowed = allowed & (qpos[:, None] >= kpos[None, :])[None]
        s = torch.where(allowed[:, None], s, NEG_INF)
    elif causal:
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    return s


def _chunk_for(s_len: int) -> int:
    """Largest power-of-two chunk <= 1024 dividing the sequence length."""
    c = 1024
    while c > 1 and s_len % c != 0:
        c //= 2
    return c


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention, (b, h, s, d) -> (b, h, s, d).

    Up to ``CHUNKED_ATTN_THRESHOLD`` positions the whole score matrix is
    materialized; past it the key axis runs in online-softmax chunks
    (``p`` cast to v's dtype before ``p·V``, sums in float32), as the
    JAX package does."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s_len = k.shape[2]
    if s_len <= CHUNKED_ATTN_THRESHOLD:
        s = _block_scores(q, k, scale, 0, 0, causal, seg, seg)
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p, v.float()).to(q.dtype)
    chunk = _chunk_for(s_len)
    acc = torch.zeros(q.shape[:3] + (v.shape[3],), dtype=torch.float32,
                      device=q.device)
    m = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    for off in range(0, s_len, chunk):
        kb, vb = k[:, :, off:off + chunk], v[:, :, off:off + chunk]
        sk = None if seg is None else seg[:, off:off + chunk]
        s = _block_scores(q, kb, scale, 0, off, causal, seg, sk)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _f32_matmul(p.to(vb.dtype), vb)
        m = m_new
    return (acc / l).to(q.dtype)

"""Plain attention and ring attention over the ``seq`` mesh axis (the
JAX package's ``parallel/ring.py``).

The mask rule for packed documents (``seg``, 0 = padding) is the JAX
package's::

    allowed(iq, jk) = causal(iq >= jk)
                      & ((seg_q == seg_k & seg_q != 0) | iq == jk)

Masked scores get ``NEG_INF`` (a large negative, not ``-inf``, so exp
and where stay NaN-free).

Ring attention (:func:`ring_attention`): a rank of the ``seq`` axis
holds its Q / K / V block of ``s / n`` positions; the K / V blocks (and
their segment ids) rotate around the axis's ring (:func:`~.mesh.
ring_shift`, the counterpart of ``lax.ppermute``) while every rank folds
each block into its Q block's online-softmax state, in global positions
(``q_off = my * s_local``, ``k_off = src * s_local``).  Under ``causal``
a block from a later rank (``src > my``) is wholly masked and skipped:
it would add ``exp(NEG_INF - m) = 0``.  The backward
(:class:`RingAttention`) walks the same ring again from the saved
log-sum-exp, and each block's dK / dV partial travels with the block, so
one more rotation returns it to its owner: what JAX's transpose of
``ppermute`` does.  The block products are float32 ``torch.matmul``, as
the JAX package leaves them to XLA.
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


def _empty_state(q, v):
    """The (acc, m, l) online-softmax state before any key, float32."""
    dev = q.device
    return (torch.zeros(q.shape[:3] + (v.shape[3],), dtype=torch.float32,
                        device=dev),
            torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                       device=dev),
            torch.zeros(q.shape[:3] + (1,), dtype=torch.float32, device=dev))


def _online_update(s, v, acc, m, l):
    """One flash-attention accumulation step in float32 (``p`` cast to
    ``v``'s dtype before ``p·V``, as the JAX package does)."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + _f32_matmul(p.to(v.dtype), v)
    return acc, m_new, l


def _key_chunks(s_len: int):
    """The key-axis chunk offsets and width of one block: the whole block
    up to ``CHUNKED_ATTN_THRESHOLD`` positions (or when no smaller chunk
    divides it), else ``_chunk_for``'s chunks."""
    chunk = _chunk_for(s_len)
    if chunk == s_len or s_len <= CHUNKED_ATTN_THRESHOLD:
        return [0], s_len
    return list(range(0, s_len, chunk)), chunk


def _accumulate_block(q, k, v, scale, q_off, k_off, causal, acc, m, l,
                      seg_q=None, seg_k=None):
    """Fold one K / V block into the (acc, m, l) online-softmax state,
    its key axis in chunks when it is long (peak memory O(s_q · chunk)),
    the JAX package's ``_accumulate_block``."""
    offs, chunk = _key_chunks(k.shape[2])
    for off in offs:
        sk = None if seg_k is None else seg_k[:, off:off + chunk]
        s = _block_scores(q, k[:, :, off:off + chunk], scale, q_off,
                          k_off + off, causal, seg_q, sk)
        acc, m, l = _online_update(s, v[:, :, off:off + chunk], acc, m, l)
    return acc, m, l


def _block_grads(q, k, v, dout, lse, delta, scale, q_off, k_off, causal,
                 seg_q, seg_k, dq, dk, dv):
    """The flash backward of one K / V block from the saved log-sum-exp
    ``lse`` and ``delta = rowsum(dO · O)``: adds the block's share to
    ``dq`` and its gradients to ``dk`` / ``dv`` (float32, in place)."""
    offs, chunk = _key_chunks(k.shape[2])
    for off in offs:
        sl = slice(off, off + chunk)
        sk = None if seg_k is None else seg_k[:, sl]
        kb, vb = k[:, :, sl].float(), v[:, :, sl].float()
        s = _block_scores(q, kb, scale, q_off, k_off + off, causal, seg_q,
                          sk)
        p = torch.exp(s - lse)
        ds = p * (torch.matmul(dout, vb.transpose(-1, -2)) - delta)
        dq.add_(torch.matmul(ds, kb), alpha=scale)
        dk[:, :, sl].add_(torch.matmul(ds.transpose(-1, -2), q.float()),
                          alpha=scale)
        dv[:, :, sl].add_(torch.matmul(p.transpose(-1, -2), dout))


def _ring_pos(mesh, axis: str):
    return mesh.axis_size(axis), mesh.axis_index(axis)


class RingAttention(torch.autograd.Function):
    """Ring attention over ``axis`` of ``mesh`` on this rank's (b, h,
    s_local, d) blocks (module docstring); ``seg`` is the rank's (b,
    s_local) segment ids or None."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, axis, causal, scale):
        from . import mesh as meshlib
        n, my = _ring_pos(mesh, axis)
        s_local = q.shape[2]
        acc, m, l = _empty_state(q, v)
        kk, vv, sk = k, v, seg
        for i in range(n):
            src = (my - i) % n  # the rank whose K / V block is held
            if not (causal and src > my):
                acc, m, l = _accumulate_block(
                    q, kk, vv, scale, my * s_local, src * s_local, causal,
                    acc, m, l, seg_q=seg, seg_k=sk)
            if i + 1 < n:
                kk = meshlib.ring_shift(kk, mesh, axis)
                vv = meshlib.ring_shift(vv, mesh, axis)
                if sk is not None:
                    sk = meshlib.ring_shift(sk, mesh, axis)
        out = (acc / l).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l),
                              *(() if seg is None else (seg,)))
        ctx.ring = (mesh, axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        from . import mesh as meshlib
        q, k, v, out, lse, *segs = ctx.saved_tensors
        seg = segs[0] if segs else None
        mesh, axis, causal, scale = ctx.ring
        n, my = _ring_pos(mesh, axis)
        s_local = q.shape[2]
        dout = dout.float()
        delta = (dout * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kk, vv, sk = k, v, seg
        for i in range(n):
            src = (my - i) % n
            if not (causal and src > my):
                _block_grads(q, kk, vv, dout, lse, delta, scale,
                             my * s_local, src * s_local, causal, seg, sk,
                             dq, dk, dv)
            if i + 1 < n:
                kk = meshlib.ring_shift(kk, mesh, axis)
                vv = meshlib.ring_shift(vv, mesh, axis)
                if sk is not None:
                    sk = meshlib.ring_shift(sk, mesh, axis)
                # the block's gradient travels with the block
                dk = meshlib.ring_shift(dk, mesh, axis)
                dv = meshlib.ring_shift(dv, mesh, axis)
        if n > 1:
            # the held block is the next rank's: hand its gradient home
            dk = meshlib.ring_shift(dk, mesh, axis)
            dv = meshlib.ring_shift(dv, mesh, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "seq", causal: bool = False,
                   scale: Optional[float] = None,
                   seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention of this rank's Q block over the whole sequence,
    its (b, h, s_local, d) blocks sharded over ``axis`` (rank ``i`` holds
    positions ``[i·s_local, (i+1)·s_local)``); ``seg`` the rank's (b,
    s_local) segment ids, which rotate with their K / V blocks.  Equal
    to :func:`dense_attention` on the gathered arrays."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return RingAttention.apply(q, k, v, seg, mesh, axis, bool(causal),
                               float(scale))


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, causal: bool = False, seq_axis: str = "seq",
                      seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``sharded_attention`` for a rank of the port:
    each rank already holds its batch rows (``data``) and its positions
    (``seq_axis``), so this is :func:`ring_attention` over
    ``seq_axis``; heads stay whole (the port holds no head shards)."""
    return ring_attention(q, k, v, mesh, seq_axis, causal=causal, seg=seg)


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
    acc, m, l = _accumulate_block(q, k, v, scale, 0, 0, causal,
                                  *_empty_state(q, v), seg_q=seg, seg_k=seg)
    return (acc / l).to(q.dtype)

"""The benchmark's frozen arithmetic: the card's published peaks, the
least time of a piece of work, the (query, key) pairs a segmented causal
mask keeps, and the operations and bytes of the layers the per-layer
metrics bound.

Copied so that a later change to the program cannot move the yardstick:

* ``PEAK_*`` and :func:`bound_s`: ``cxxnet_tpu_torch/analysis/costmodel.py``
  (the H100 SXM data sheet, dense rates) and ``chip_smoke.py`` ``peaks``
  / ``bound``;
* :func:`live_pairs`: ``chip_smoke.py`` ``live_pairs``, taking segment ids
  as the packer lays them out (0 = padding, whose positions keep their
  diagonal);
* the conv counts: ``analysis/costmodel.py`` ``layer_costs`` (2 x
  MACs); the attention, LRN and pool counts are the least
  each kernel's inputs need: every input byte read once, every output
  byte written once, no recompute counted.

Nothing here imports torch or the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

#: dense bf16 tensor-core peak (FLOP/s)
PEAK_BF16 = 989e12
#: HBM3 bandwidth (bytes/s)
PEAK_BW = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16,
            bw: float = PEAK_BW) -> float:
    """The least time, in seconds, for ``flops`` operations and ``nbytes``
    of memory traffic: the larger of the two at the published peaks."""
    return max(flops / peak, nbytes / bw)


def live_pairs_rows(seg: np.ndarray) -> np.ndarray:
    """Per row of ``seg`` (rows, s), the (query, key) pairs a segmented
    causal mask keeps: each document's triangle n (n + 1) / 2, plus the
    diagonal of every padding position (segment 0)."""
    seg = np.asarray(seg)
    out = np.zeros(seg.shape[0], np.int64)
    for r, row in enumerate(seg):
        _, n = np.unique(row[row != 0], return_counts=True)
        n = n.astype(np.int64)
        out[r] = int((n * (n + 1) // 2).sum()) + int((row == 0).sum())
    return out


def live_pairs(seg: np.ndarray, heads: int = 1) -> int:
    """All rows' live pairs, times ``heads``."""
    return int(live_pairs_rows(seg).sum()) * heads


# ------------------------------------------------------------ attention
#: FLOPs a live pair needs per head column: forward QK^T and PV (2 + 2),
#: backward dV, dP, dQ, dK (2 each), no recompute of the scores
ATTN_FWD_FLOPS_PER_PAIR_COL = 4
ATTN_BWD_FLOPS_PER_PAIR_COL = 8


def attention_cost(pairs: int, tokens: int, heads: int, head_dim: int,
                   elem_bytes: int = 2) -> Dict[str, Dict[str, float]]:
    """Operations and bytes of one segmented causal attention call over
    ``tokens`` positions (all rows) with ``pairs`` live pairs per head:
    the forward reads q, k, v and writes o and the log-sum-exp (float32);
    the backward reads q, k, v, o, do and the log-sum-exp and writes dq,
    dk, dv."""
    col = tokens * heads * head_dim * elem_bytes
    lse = tokens * heads * 4
    return {
        "fwd": {"flops": float(ATTN_FWD_FLOPS_PER_PAIR_COL * pairs * heads
                               * head_dim),
                "bytes": float(4 * col + lse)},
        "bwd": {"flops": float(ATTN_BWD_FLOPS_PER_PAIR_COL * pairs * heads
                               * head_dim),
                "bytes": float(8 * col + lse)},
    }


# ------------------------------------------------------------ conv / fc
def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    """Conv output side ((i + 2p - k) / s + 1)."""
    return (size + 2 * pad - k) // stride + 1


def pool_out(size: int, k: int, stride: int) -> int:
    """Max-pool output side with a clipped tail window (the source's
    pooling_layer-inl.hpp)."""
    return min(size - k + stride - 1, size - 1) // stride + 1


def conv_macs(n: int, cin: int, cout: int, oh: int, ow: int, kh: int,
              kw: int, groups: int = 1) -> float:
    return float(n) * cout * oh * ow * (cin // groups) * kh * kw


def wgrad_cost(n, cin, cout, h, w, oh, ow, kh, kw, groups=1,
               elem_bytes: int = 2) -> Dict[str, float]:
    """A conv's weight gradient: 2 x MACs; reads the input and the
    output gradient, writes the float32 weight gradient."""
    return {"flops": 2.0 * conv_macs(n, cin, cout, oh, ow, kh, kw, groups),
            "bytes": float(n * cin * h * w * elem_bytes
                           + n * cout * oh * ow * elem_bytes
                           + cout * (cin // groups) * kh * kw * 4)}


def lrn_cost(numel: int, nsize: int, backward: bool,
             elem_bytes: int = 2) -> Dict[str, float]:
    """LRN over ``numel`` elements: the forward reads x and writes y, the
    backward reads x and dy and writes dx; about 2 n + 6 operations an
    element."""
    return {"flops": float((2 * nsize + 6) * numel * (2 if backward else 1)),
            "bytes": float((3 if backward else 2) * numel * elem_bytes)}


def pool_cost(in_numel: int, out_numel: int, k: int, backward: bool,
              elem_bytes: int = 2) -> Dict[str, float]:
    """Max pooling: the forward reads x and writes y; the backward reads
    x and dy and writes dx."""
    if backward:
        return {"flops": float(k * k * out_numel),
                "bytes": float((2 * in_numel + out_numel) * elem_bytes)}
    return {"flops": float(k * k * out_numel),
            "bytes": float((in_numel + out_numel) * elem_bytes)}


def sum_bound_s(costs: Iterable[Dict[str, float]],
                peak: float = PEAK_BF16) -> float:
    """Summed least time of separate launches."""
    return sum(bound_s(c["flops"], c["bytes"], peak) for c in costs)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))

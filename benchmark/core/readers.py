"""What the per-layer metric readers (``metrics/<name>.py``) share: each
reader is ``read(run) -> value or None`` over a traced run's
:class:`~benchmark.core.harness.Run`, and returns None where it finds
nothing sound to read (no trace, a trace that lost kernels' events, a
kernel that did not launch as the configuration says), never 0."""

from __future__ import annotations

import sys
from typing import Dict, Optional

from . import arith, trace as tracelib


def note(run, what: str) -> None:
    print(f"bench: {run.cell['name']}: {what}", file=sys.stderr)


def span_ms(run, name: str) -> Optional[float]:
    """Mean host milliseconds a call of the benchmark's span ``name``."""
    n = run.spans.calls.get(name, 0)
    return run.spans.seconds[name] / n * 1e3 if n else None


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no device event ran."""
    if not run.trace_ok:
        return None
    s = run.trace_summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu_pct(run, flops: float) -> Optional[float]:
    """``flops`` over the traced window's length, as a share of the bf16
    peak."""
    if run.events is None or run.traced_steps <= 0:
        return None
    return 100.0 * flops / run.trace_summary["window_s"] / arith.PEAK_BF16


def launches_hold(run, want: Dict[str, int]) -> bool:
    """True when each group of wrappers (``"a|b"``: summed) launched
    ``want`` times a traced step."""
    for names, per in want.items():
        got = sum(run.launches.get(n, 0) for n in names.split("|"))
        if got != per * run.traced_steps:
            note(run, f"{names}: {got} launches in {run.traced_steps} "
                 f"traced steps, {per} a step expected")
            return False
    return True


def roofline_pct(run, wrappers, bound_s: float) -> Optional[float]:
    """``bound_s`` (the least time of the launches) over the summed device
    time of the wrappers' kernels in the traced window."""
    if not run.trace_ok:
        return None
    from cxxnet_tpu_torch.ops import WRAPPERS
    us = tracelib.kernel_us(run.events, tracelib.kernel_names(WRAPPERS,
                                                              wrappers))
    if us <= 0:
        return None
    return 100.0 * bound_s / (us * 1e-6)


# ------------------------------------------------------------- the LM
def lm_seg(run):
    """Segment ids of each traced step's rows."""
    seq = run.info["seq"]
    return [lab[:, seq:2 * seq] for lab in run.info["labels"]
            [:run.traced_steps]]


def lm_dims(run) -> dict:
    return run.reference.dims(run.config)


def lm_step_flops(run) -> float:
    """Model operations of the traced steps: 6 per matmul weight a
    position, plus the attention over the live pairs (forward and
    backward, no recompute), every layer."""
    g = lm_dims(run)
    hd = g["d"] // g["H"]
    per_pair = (arith.ATTN_FWD_FLOPS_PER_PAIR_COL
                + arith.ATTN_BWD_FLOPS_PER_PAIR_COL) * hd * g["H"] * g["L"]
    total = 0.0
    for seg in lm_seg(run):
        total += 6.0 * run.reference.matmul_params(run.config) * seg.size
        total += per_pair * arith.live_pairs(seg)
    return total


def lm_attention_bound_s(run) -> float:
    g = lm_dims(run)
    hd = g["d"] // g["H"]
    t = 0.0
    for seg in lm_seg(run):
        c = arith.attention_cost(arith.live_pairs(seg), seg.size, g["H"], hd)
        t += g["L"] * arith.sum_bound_s((c["fwd"], c["bwd"]))
    return t


# ------------------------------------------------------------ the CNN
def cnn_kernel_bound_s(run, backward: bool) -> float:
    """Least time a step (a batch) of the LRN and max-pool launches, and
    in training of conv1's weight gradient, from the configuration's
    shapes."""
    geo = run.reference.geometry(run.config, run.traffic["batch"])
    costs = [arith.lrn_cost(l["numel"], l["nsize"], False)
             for l in geo["lrns"]]
    costs += [arith.pool_cost(p["in"], p["out"], p["k"], False)
              for p in geo["pools"]]
    if backward:
        costs += [arith.lrn_cost(l["numel"], l["nsize"], True)
                  for l in geo["lrns"]]
        costs += [arith.pool_cost(p["in"], p["out"], p["k"], True)
                  for p in geo["pools"]]
        c = geo["convs"][0]
        costs.append(arith.wgrad_cost(c["n"], c["cin"], c["cout"], c["h"],
                                      c["h"], c["oh"], c["oh"], c["k"],
                                      c["k"], c["groups"]))
    return arith.sum_bound_s(costs) * run.traced_steps

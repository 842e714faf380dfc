"""Cross-run regression diff: the ONE threshold/comparison engine (the
JAX package's ``monitor/diff.py``).

A "faster" claim needs a baseline and a verdict, not two tables a human
squints at; canary/rollback-on-regression needs the same run-vs-run
verdict as a primitive.  This module is that
primitive, shared by every consumer so exactly one comparison
implementation exists:

* ``tools/obsv.py --diff A.jsonl B.jsonl`` — align two metrics streams
  (throughput, ledger shares, per-layer ``layer_profile`` rows joined
  by the stable ``conn_scope_name`` contract, ``mem_profile``
  peak-live, comm share/overlap, latency percentiles) and exit nonzero
  on any regression past ``rel`` — a CI gate, not just a report;
* ``bench.py --against BENCH_rNN.json`` — the same engine over a bench
  payload vs a recorded round;
* ``tests/test_bench_guard.py`` — the ±10% ``device_step_ms`` guard
  routes its comparison through :func:`compare`.

Verdict semantics: ``b`` is the candidate, ``a`` the baseline;
``rel_delta = (b - a) / |a|``.  A comparison regresses when the delta
moves past ``rel`` in the metric's bad direction AND the absolute move
clears the metric's significance floor (so a 0.01→0.02 share wiggle on
a 50-second CPU run cannot fail CI); it improves symmetrically.  A
metric missing from either side is not compared — absence is reported,
never judged.  A metric with direction ``None`` rides as CONTEXT: its
delta is shown but never gates.  The ledger needs that distinction:
utilization (``goodput_pct``, the dispatch share) RISES when the
device gets slower, and compile/eval/other shares shift with run shape
— speed verdicts come from throughput and latency, while the judged
ledger rows are the shares whose growth is unambiguous badput
(``input_wait``, ``h2d_staging``, ``ckpt_blocked``, ``rollback_lost``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .ledger import CATEGORIES, build_ledger, by_kind as _by_kind, \
    last_session

#: metric directions: which way is worse
LOWER_BETTER = "lower_better"    # an increase is a regression
HIGHER_BETTER = "higher_better"  # a decrease is a regression


def compare(metric: str, a, b, rel: float = 0.10,
            direction: Optional[str] = LOWER_BETTER,
            abs_floor: float = 0.0) -> dict:
    """One comparison: candidate ``b`` against baseline ``a``.
    ``direction = None`` computes the delta but never judges (a
    context row)."""
    out = {"metric": metric, "a": a, "b": b, "direction": direction,
           "rel_delta": None, "regressed": False, "improved": False}
    if a is None or b is None:
        return out
    a, b = float(a), float(b)
    if a == 0.0:
        # no baseline magnitude, no RELATIVE verdict (a 10% threshold
        # of zero is meaningless) — but a metric with a significance
        # floor is still judged by its absolute move: a clean baseline
        # has rollback_lost/ckpt_blocked shares of exactly 0.0, and
        # those are precisely the badput classes the gate exists for
        out["rel_delta"] = 0.0 if b == 0.0 else None
        if direction is not None and abs_floor > 0.0 \
                and abs(b - a) >= abs_floor:
            grew = b > a
            out["regressed"] = grew == (direction == LOWER_BETTER)
            out["improved"] = not out["regressed"]
        return out
    delta = (b - a) / abs(a)
    out["rel_delta"] = round(delta, 4)
    if direction is None or abs(b - a) < abs_floor:
        return out
    bad = delta > rel if direction == LOWER_BETTER else delta < -rel
    good = delta < -rel if direction == LOWER_BETTER else delta > rel
    out["regressed"] = bool(bad)
    out["improved"] = bool(good)
    return out


# ------------------------------------------------- metric extraction
#: ledger shares whose growth is unambiguous badput — the JUDGED rows.
#: compile/eval/other shift with run shape, and the dispatch share
#: (goodput) rises when the device merely slows down; those ride as
#: context rows (direction None) instead
_JUDGED_SHARES = ("pipe_bubble", "input_wait", "h2d_staging",
                  "ckpt_blocked", "rollback_lost")


def run_metrics(recs: List[dict]
                ) -> Dict[str, Tuple[float, Optional[str], float]]:
    """Extract the comparable scalars of one run:
    ``name -> (value, direction_or_None, abs_floor)``."""
    by = _by_kind(recs)
    out: Dict[str, Tuple[float, str, float]] = {}
    eps = [r["examples_per_sec"] for r in by.get("step", [])
           if r.get("examples_per_sec")]
    if eps:
        # the mean over all print windows is the judged throughput
        # signal; the final window is ONE sample — scheduler wiggle on
        # a short run routinely moves it past any rel threshold, so it
        # rides as context
        out["examples_per_sec_mean"] = (sum(eps) / len(eps),
                                        HIGHER_BETTER, 0.0)
        out["examples_per_sec_last"] = (eps[-1], None, 0.0)
    led = by.get("ledger", [None])[-1] or build_ledger(recs,
                                                       source="posthoc")
    if led:
        # context: utilization is not speed (a slower kernel RAISES it)
        out["goodput_pct"] = (led.get("goodput_pct"), None, 0.0)
        shares = led.get("shares") or {}
        for cat in CATEGORIES:
            if cat not in shares or cat == "dispatch":
                continue  # dispatch share == goodput_pct, one row
            if cat in _JUDGED_SHARES:
                # floor 0.02: a two-points-of-wall move is the smallest
                # share shift worth a verdict on CI-sized runs
                out[f"ledger_share_{cat}"] = (shares[cat],
                                              LOWER_BETTER, 0.02)
            else:
                out[f"ledger_share_{cat}"] = (shares[cat], None, 0.0)
    if by.get("trace"):
        t = by["trace"][-1]
        if t.get("comm_share") is not None:
            out["comm_share"] = (t["comm_share"], LOWER_BETTER, 0.02)
        if t.get("overlap_frac") is not None:
            out["overlap_frac"] = (t["overlap_frac"], HIGHER_BETTER, 0.05)
    if by.get("mem_profile"):
        m = by["mem_profile"][-1]
        if m.get("peak_live_bytes") is not None:
            out["peak_live_bytes"] = (m["peak_live_bytes"],
                                      LOWER_BETTER, 0.0)
        if m.get("hbm_peak_bytes") is not None:
            out["hbm_peak_bytes"] = (m["hbm_peak_bytes"],
                                     LOWER_BETTER, 0.0)
    for r in by.get("latency", []):
        op = r.get("op", "?")
        for q in ("p50", "p95", "p99"):
            if r.get(q) is not None:
                # floor 0.2 ms: below that, CPU-CI timer noise
                out[f"{op}_{q}_ms"] = (r[q], LOWER_BETTER, 0.2)
    if by.get("serve"):
        s = by["serve"][-1]
        if s.get("qps") is not None:
            out["serve_qps"] = (s["qps"], HIGHER_BETTER, 0.0)
    return out


def layer_rows(recs: List[dict]) -> Dict[str, float]:
    """``layer -> device_ms`` from the last ``layer_profile`` record —
    the join key is the ``conn_scope_name`` contract (layers/base.py),
    stable across runs of the same config."""
    by = _by_kind(recs)
    if not by.get("layer_profile"):
        return {}
    rows = by["layer_profile"][-1].get("rows") or []
    return {r["layer"]: r.get("device_ms")
            for r in rows if r.get("layer") is not None}


def diff_runs(recs_a: List[dict], recs_b: List[dict],
              rel: float = 0.10) -> dict:
    """Align two record streams and judge every shared metric.  Each
    stream is sliced to its LAST session first (ledger.last_session):
    an append-mode sink carries earlier sessions, and mixing their step
    records into the mean would judge a run neither side actually
    ran."""
    recs_a, recs_b = last_session(recs_a), last_session(recs_b)
    ma, mb = run_metrics(recs_a), run_metrics(recs_b)
    metrics = []
    for name in ma:
        if name not in mb:
            continue
        va, direction, floor = ma[name]
        vb = mb[name][0]
        metrics.append(compare(name, va, vb, rel=rel,
                               direction=direction, abs_floor=floor))
    la, lb = layer_rows(recs_a), layer_rows(recs_b)
    layers = [compare(name, la[name], lb[name], rel=rel,
                      direction=LOWER_BETTER, abs_floor=0.05)
              for name in la if name in lb]
    all_cmp = metrics + layers
    return {
        "rel": rel,
        "metrics": metrics,
        "layers": layers,
        "layers_only_a": sorted(set(la) - set(lb)),
        "layers_only_b": sorted(set(lb) - set(la)),
        "uncompared": sorted(set(ma) ^ set(mb)),
        "regressions": sum(1 for c in all_cmp if c["regressed"]),
        "improvements": sum(1 for c in all_cmp if c["improved"]),
    }


# --------------------------------------------------------- bench diff
def bench_direction(key: str) -> Optional[str]:
    """Direction heuristic over the BENCH payload field vocabulary
    (doc/monitor.md: shared with the JSONL records).  None = not a
    judged metric (counts, ids, configuration).  The higher-better
    vocabulary is tested FIRST: throughput fields end in ``_sec`` too
    (``imgs_per_sec``), and a suffix-first rule would invert their
    verdict — the exact wrong-way CI gate this module exists to
    prevent."""
    k = key.lower()
    if k in ("trials", "ts", "n", "rc", "devices", "batch", "clients"):
        return None
    if ("per_sec" in k or "per_chip" in k or "qps" in k or "mfu" in k
            or "speedup" in k or "efficiency" in k or "tokens" in k):
        return HIGHER_BETTER
    if "_ms" in k or k.endswith("ms") or "latency" in k \
            or "compile" in k or k.endswith("_sec"):
        return LOWER_BETTER
    return None


def _bench_flat(payload: dict, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in payload.items():
        name = prefix + k
        if isinstance(v, dict):
            out.update(_bench_flat(v, name + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = float(v)
    return out


def diff_bench(prior: dict, current: dict, rel: float = 0.10) -> dict:
    """Judge a bench payload against a recorded one.  ``BENCH_rNN.json``
    round files wrap the payload in ``parsed`` — both shapes accepted.
    Direction comes from the field name (the leaf key of a dotted
    path), so ``arms.fused.step_ms`` is judged lower-better.  The
    generic headline fields ``value``/``vs_baseline`` are named by the
    sibling ``metric`` string — ``serve_p95_ms`` and ``opt_ab_step_ms``
    headlines are LOWER-better — so their direction derives from it,
    never from the literal key (an unrecognized metric name leaves them
    uncompared rather than guessed)."""
    prior = prior.get("parsed", prior)
    current = current.get("parsed", current)
    head_dir = bench_direction(str(prior.get("metric", "")))
    fa, fb = _bench_flat(prior), _bench_flat(current)
    metrics = []
    for name in fa:
        if name not in fb:
            continue
        leaf = name.rsplit(".", 1)[-1]
        direction = head_dir if leaf in ("value", "vs_baseline") \
            else bench_direction(leaf)
        if direction is None:
            continue
        metrics.append(compare(name, fa[name], fb[name], rel=rel,
                               direction=direction))
    return {
        "rel": rel,
        "metrics": metrics,
        "uncompared": sorted(set(fa) ^ set(fb)),
        "regressions": sum(1 for c in metrics if c["regressed"]),
        "improvements": sum(1 for c in metrics if c["improved"]),
    }


# ---------------------------------------------------------- rendering
def _fmt_val(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}M"
    return f"{v:.4g}"


def _verdict(c: dict) -> str:
    if c["regressed"]:
        return "REGRESSED"
    if c["improved"]:
        return "improved"
    if c["rel_delta"] is None:
        return "-"
    if c.get("direction") is None:
        return "(ctx)"  # context row: shown, never judged
    return "ok"


def render_diff(d: dict, label_a: str = "A", label_b: str = "B") -> str:
    """Aligned terminal table for a :func:`diff_runs` /
    :func:`diff_bench` result."""
    lines = [f"run diff: {label_b} (candidate) vs {label_a} (baseline), "
             f"rel threshold {d['rel']:.0%}"]
    rows = []
    for c in d.get("metrics", []) + d.get("layers", []):
        delta = ("-" if c["rel_delta"] is None
                 else f"{c['rel_delta']:+.1%}")
        rows.append([c["metric"], _fmt_val(c["a"]), _fmt_val(c["b"]),
                     delta, _verdict(c)])
    if rows:
        headers = ["metric", label_a, label_b, "delta", "verdict"]
        widths = [max(len(h), *(len(r[i]) for r in rows))
                  for i, h in enumerate(headers)]
        fmt = "  ".join(f"{{:>{w}}}" for w in widths)
        lines.append(fmt.format(*headers))
        lines.extend(fmt.format(*r) for r in rows)
    else:
        lines.append("(no shared metrics to compare)")
    for side, only in (("only in " + label_a, d.get("layers_only_a")),
                       ("only in " + label_b, d.get("layers_only_b"))):
        if only:
            lines.append(f"layers {side}: {', '.join(only)}")
    lines.append(
        f"verdict: {d['regressions']} regression(s), "
        f"{d['improvements']} improvement(s)"
        + (" — FAIL" if d["regressions"] else " — ok"))
    return "\n".join(lines)

"""Goodput ledger: where a whole run's wall clock went (doc/monitor.md;
the JAX package's ``monitor/ledger.py``).

The observatory can decompose one run three ways — per-layer device
time (attribution.py), host spans (spans.py), HBM (memory.py) — but
none of them answers the operator's first question: *what fraction of
this run's wall was useful work?*  :func:`build_ledger` folds the
records a training run already emits (``compile`` / ``step`` /
``round`` / ``ckpt`` / ``rollback``) into one end-of-run ``ledger``
record attributing the measured wall into categories:

========================  ====================================================
``compile``               the first dispatch's wall (trace + compile in the
                          JAX package; kernel builds, library autotune and
                          allocator warm-up in this one)
``dispatch``              host wall spent dispatching train steps — the
                          useful-work category goodput is computed from
``pipe_bubble``           pipeline fill/drain idle inside the dispatched
                          step: ``dispatch × pipe_bubble_frac`` carved out
                          of the useful-work category.  Producers stamp
                          ``pipe_bubble_frac`` (analytic ``(S-1)/(M+S-1)``
                          from the trainer) on step/round records of
                          pipelined runs; absent field → 0 carve
``input_wait``            blocked on the host iterator / staging queue
``h2d_staging``           critical-path device staging (stack + cast +
                          transfer).  With ``prefetch_device > 0`` the
                          transfer ran on the producer thread and OVERLAPPED
                          compute, so only the part that fits the residual
                          wall is booked here; the rest is reported as
                          ``h2d_overlapped_sec`` (informational, not a
                          category — it cost no wall)
``eval``                  round-boundary evaluation passes
``ckpt_blocked``          what the train loop paid for snapshots (host pull
                          + bounded-queue backpressure; the off-thread write
                          wall is in the ``ckpt`` records, not here)
``rollback_lost``         work later discarded by a divergence rollback: the
                          full wall (train + eval) of every completed round
                          past the restored snapshot, plus the dying round's
                          partial step accounting
``other``                 the residual — init, iterator construction, metric
                          math, logging, the untimed tail of the dying round
========================  ====================================================

The categories tile the wall by construction (``other`` is the
residual), so ``sum(categories) == wall_sec`` up to rounding — asserted
within 5% on the CPU MNIST e2e (tests/test_ledger.py).  ``goodput_pct``
is ``dispatch / wall``.

Two producers share this one fold: the task ``finally`` in main.py
re-reads its own sink file and emits the record even when the run died
in ``TrainingDiverged``; ``tools/obsv.py`` recomputes it post-hoc for
any historical JSONL that lacks one (``source = "posthoc"``, wall from
the record timestamp span).  The cross-run comparator
(monitor/diff.py, ``tools/obsv.py --diff``) compares the shares.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from . import log as mlog

#: ledger categories, in render order; they tile ``wall_sec``
CATEGORIES = ("compile", "dispatch", "pipe_bubble", "input_wait",
              "h2d_staging", "eval", "ckpt_blocked", "rollback_lost",
              "other")


def parse_record_line(line: str):
    """One JSONL line -> a record dict, or None (blank / not a record).
    Raises ValueError on an unparseable line — callers decide the skip
    policy (load_records counts + warns once; the obsv Follower keeps a
    torn tail buffered instead).  The ONE per-line parse every tolerant
    reader shares."""
    line = line.strip()
    if not line:
        return None
    r = json.loads(line)
    return r if isinstance(r, dict) and "kind" in r else None


def load_records(path: str, who: str = "ledger",
                 offset: int = 0) -> List[dict]:
    """Tolerant JSONL reader: every well-formed ``{"kind": ...}`` object
    in the file, in order.  A run killed mid-``sink.write`` leaves a
    torn final line — that (or any other unparseable line) is SKIPPED
    with one warning per read instead of raising ``JSONDecodeError``
    and making the run's own report unreadable.  ``offset`` skips bytes
    already accounted elsewhere (the sink opens append-mode, so a
    reused path carries earlier sessions; the task ledger anchors at
    the file size it saw at run start)."""
    recs: List[dict] = []
    skipped = 0
    with open(path) as f:
        if offset:
            f.seek(offset)
        for line in f:
            try:
                r = parse_record_line(line)
            except ValueError:
                skipped += 1
                continue
            if r is not None:
                recs.append(r)
    if skipped:
        # one warning per read, never per line — a torn tail is one fact
        mlog.warn(f"{who}: {path}: skipped {skipped} unparseable JSONL "
                  "line(s) (the torn tail a killed run leaves mid-write)")
    return recs


def by_kind(recs: List[dict]) -> Dict[str, List[dict]]:
    """Group a record stream by ``kind`` (insertion-ordered) — shared
    by the diff engine and the obsv report so the two readers can
    never diverge on grouping."""
    out: Dict[str, List[dict]] = {}
    for r in recs:
        out.setdefault(r.get("kind", ""), []).append(r)
    return out


def last_session(recs: List[dict]) -> List[dict]:
    """The LAST session's records in a (possibly multi-session,
    append-mode) stream.  Sessions end with their ``ledger`` record, so
    the last session is everything after the previous ledger: when the
    stream ends with a ledger, the segment between the second-to-last
    ledger and the end (that completed run); otherwise the trailing
    unledgered records (the live / killed run).  Streams without any
    ledger pass through whole.  Read-side consumers (the run report,
    the cross-run diff) slice here so their throughput/layer/latency
    numbers describe the same session the ledger does.

    Known limit: a predecessor KILLED before its own ledger landed
    leaves no boundary a reader can find, so its records blend into
    the next session's read-side metrics (the producer's emitted
    ledger stays correct — it anchors at the byte offset it saw at
    run start).  Prefer a fresh ``metrics_sink`` path per run when a
    diff must be exact after crashes (doc/monitor.md)."""
    idx = [i for i, r in enumerate(recs) if r.get("kind") == "ledger"]
    if not idx:
        return recs
    if idx[-1] == len(recs) - 1:
        start = idx[-2] + 1 if len(idx) > 1 else 0
    else:
        start = idx[-1] + 1
    return recs[start:]


def _f(rec: dict, key: str) -> float:
    v = rec.get(key)
    return float(v) if v is not None else 0.0


def build_ledger(recs: List[dict],
                 wall_sec: Optional[float] = None,
                 source: str = "run") -> Optional[dict]:
    """Fold a record stream into the ledger dict (the ``ledger`` record
    body).  ``wall_sec`` is the measured task wall when the producer
    knows it (the task ``finally``); None derives it from the stream's
    timestamp span (the post-hoc path).  Returns None when the stream
    carries nothing to account (no records at all).

    The sink opens append-mode, so a reused ``metrics_sink`` path holds
    EARLIER sessions too; each session ends with its own ledger record,
    so the fold covers only what the last ledger in the stream did not
    — everything after it.  (A mid-stream ``run`` record is NOT a
    session boundary: rollback restores rebuild the net and emit one
    per attempt, and slicing there would discard the lost work the
    ledger exists to account.)  The one stream a ledger cannot bound —
    a predecessor killed before its own ledger landed — is handled by
    the producer's byte-offset anchor (``load_records(offset=...)``)."""
    for i in range(len(recs) - 1, -1, -1):
        if recs[i].get("kind") == "ledger":
            recs = recs[i + 1:]
            break
    compile_sec = dispatch = bubble = input_wait = eval_sec = 0.0
    h2d_raw = ckpt_blocked = lost = 0.0
    kept: List[dict] = []       # completed rounds still standing
    rounds_lost = 0
    # step records carry per-print-window marks; a round record, emitted
    # at round end, carries the SAME round's full sums — so pending step
    # marks are superseded (discarded) when their round record lands,
    # and only the dying round's partial accounting survives the stream
    pend = {"dispatch": 0.0, "bubble": 0.0, "input_wait": 0.0, "h2d": 0.0}
    # compile happens INSIDE its round's wall (the first dispatch), so
    # a rolled-back round's lost wall must shed the compile portion the
    # `compile` category already booked — the compile record's round is
    # 0-based, the round record's 1-based (same loop iteration)
    compile_by_round: Dict[int, float] = {}
    n_anom = n_nan = n_rb = 0
    first_ts: Optional[float] = None
    last_ts: Optional[float] = None
    for r in recs:
        ts = r.get("ts")
        if isinstance(ts, (int, float)):
            first_ts = ts if first_ts is None else first_ts
            last_ts = ts
        k = r.get("kind")
        if k == "compile":
            compile_sec += _f(r, "compile_sec")
            if r.get("round") is not None:
                compile_by_round[int(r["round"])] = _f(r, "compile_sec")
        elif k == "step":
            # pipelined steps spend a known fill/drain fraction of their
            # dispatch wall idle (pipe_bubble_frac, stamped by main.py):
            # carve it out of the useful-work category
            d = _f(r, "dispatch_sec")
            bub = d * _f(r, "pipe_bubble_frac")
            pend["dispatch"] += d - bub
            pend["bubble"] += bub
            pend["input_wait"] += _f(r, "iter_wait_sec")
            pend["h2d"] += _f(r, "h2d_sec")
        elif k == "round":
            kept.append(r)
            pend = {"dispatch": 0.0, "bubble": 0.0,
                    "input_wait": 0.0, "h2d": 0.0}
        elif k == "ckpt":
            ckpt_blocked += _f(r, "blocked_sec")
        elif k == "rollback":
            n_rb += 1
            restored = r.get("restored_round")
            if restored is not None:
                # completed rounds past the restored snapshot will be
                # retrained — their whole wall is lost work, and so is
                # the dying round's partial step accounting
                dead = [q for q in kept if (q.get("round") or 0) > restored]
                kept = [q for q in kept
                        if (q.get("round") or 0) <= restored]
                rounds_lost += len(dead)
                for q in dead:
                    # shed the compile wall nested in this round — it
                    # is already the `compile` category, and counting
                    # it again in rollback_lost would break the tiling
                    nested = compile_by_round.get(
                        int(q.get("round") or 0) - 1, 0.0)
                    lost += max(_f(q, "wall_sec") - nested, 0.0) \
                        + _f(q, "eval_sec")
            lost += pend["dispatch"] + pend["bubble"] \
                + pend["input_wait"] + pend["h2d"]
            pend = {"dispatch": 0.0, "bubble": 0.0,
                    "input_wait": 0.0, "h2d": 0.0}
        elif k == "anomaly":
            n_anom += 1
        elif k == "nan":
            n_nan += 1
    for r in kept:
        d = _f(r, "dispatch_sec")
        bub = d * _f(r, "pipe_bubble_frac")
        dispatch += d - bub
        bubble += bub
        input_wait += _f(r, "iter_wait_sec")
        eval_sec += _f(r, "eval_sec")
        h2d_raw += _f(r, "h2d_sec")
    # a run that died mid-round (TrainingDiverged with no rollback left)
    # leaves its last round as step marks only — book them where the
    # time actually went instead of letting the whole round read "other"
    dispatch += pend["dispatch"]
    bubble += pend["bubble"]
    input_wait += pend["input_wait"]
    h2d_raw += pend["h2d"]
    if wall_sec is None:
        if first_ts is None:
            return None
        wall_sec = max(last_ts - first_ts, 0.0)
    wall_sec = float(wall_sec)
    base = (compile_sec + dispatch + bubble + input_wait + eval_sec
            + ckpt_blocked + lost)
    residual = wall_sec - base
    # h2d that ran on the prefetch producer thread overlapped compute
    # and cost no wall: only the part that fits the residual is a
    # category (the prefetch_device = 0 case, where staging IS
    # critical-path time between dispatches)
    h2d_staging = min(h2d_raw, max(residual, 0.0))
    other = max(wall_sec - base - h2d_staging, 0.0)
    cats = {"compile": compile_sec, "dispatch": dispatch,
            "pipe_bubble": bubble, "input_wait": input_wait,
            "h2d_staging": h2d_staging, "eval": eval_sec,
            "ckpt_blocked": ckpt_blocked, "rollback_lost": lost,
            "other": other}
    cats = {k: round(v, 4) for k, v in cats.items()}
    denom = wall_sec or 1.0
    return {
        "wall_sec": round(wall_sec, 4),
        "categories": cats,
        "shares": {k: round(v / denom, 4) for k, v in cats.items()},
        "goodput_pct": round(dispatch / denom * 100.0, 2),
        "h2d_overlapped_sec": round(max(h2d_raw - h2d_staging, 0.0), 4),
        "rounds": len(kept),
        "rounds_lost": rounds_lost,
        "rollbacks": n_rb,
        "anomalies": n_anom,
        "nonfinite_steps": n_nan,
        "source": source,
    }


def format_ledger(led: dict) -> str:
    """One human line (the task-end log message and the obsv header)."""
    cats = led.get("categories") or {}
    parts = [f"{k} {cats.get(k, 0.0):.3g}s" for k in CATEGORIES
             if cats.get(k)]
    tail = ""
    if led.get("rounds_lost"):
        tail = f"; {led['rounds_lost']} round(s) lost to rollback"
    return (f"goodput {led.get('goodput_pct', 0.0):.1f}% of "
            f"{led.get('wall_sec', 0.0):.3g}s wall "
            f"({', '.join(parts)}){tail}")

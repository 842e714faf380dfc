"""Regression sentinels + flight recorder over the telemetry stream (the
JAX package's ``monitor/sentinel.py``).

The JSONL sink records what happened; nothing watched the stream for
"this run just got slower / chattier / fatter" — that was manual
archaeology over round records.  ``sentinel = 1`` (doc/monitor.md) arms
rolling-EWMA watchers over the three trend series every perf PR reads:

* ``examples_per_sec`` (step records) — throughput regressions
  (direction ``drop``: an input stall, a silent retrace, a slow disk);
* ``comm_share`` (trace records, per closed profiling window) —
  communication creep (direction ``rise``);
* ``hbm_peak_bytes`` (round records) — memory high-water creep toward
  an OOM (direction ``rise``).

Serving runs (``serve_sentinel = 1``, doc/serve.md) arm three more
over the ``serve_window`` records the task's reporter thread emits:
``serve_p99_ms`` (rise — tail-latency regression), ``serve_qps``
(drop — throughput collapse), and ``serve_queue_depth`` (rise —
standing-queue growth, the saturation precursor).  ``on_anomaly``
arms the serve host's flight capture (serve/admin.py).

Each watcher smooths its series with an EWMA and fires an ``anomaly``
record when a new value deviates more than ``sentinel_rel`` (relative)
from the smoothed baseline in its bad direction, after
``sentinel_warmup`` observations.  Anomalous values still fold into the
EWMA afterwards, so a sustained level shift fires a bounded burst while
the baseline converges instead of alarming forever.

The flight recorder keeps the last ``sentinel_ring`` step records in a
ring; an anomaly — or ``TrainingDiverged`` / any mid-round exception in
the train task — dumps the ring to the sink as one ``flight`` record,
so the steps leading INTO the incident survive the abort (the sink
flushes per record; see metrics.JsonlSink).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from .metrics import Metrics


class Ewma:
    """Exponentially-weighted mean; ``None`` until the first update."""

    __slots__ = ("alpha", "mean")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.mean: Optional[float] = None

    def update(self, value: float) -> Optional[float]:
        """Fold ``value`` in; returns the PRE-update mean (the baseline
        the value should be judged against)."""
        prev = self.mean
        self.mean = value if prev is None else (
            self.alpha * value + (1.0 - self.alpha) * prev)
        return prev


class Sentinel:
    """One watched series: EWMA baseline + relative-deviation trigger."""

    def __init__(self, metric: str, direction: str, rel: float,
                 warmup: int, alpha: float = 0.3):
        assert direction in ("drop", "rise"), direction
        self.metric = metric
        self.direction = direction
        self.rel = rel
        self.warmup = max(int(warmup), 1)
        self.ewma = Ewma(alpha)
        self.seen = 0

    def observe(self, value: float) -> Optional[Dict[str, float]]:
        """Returns the anomaly payload when ``value`` breaks the
        threshold, else None.  Zero/negative baselines never fire (a
        0 -> small hbm gauge is a backend coming online, not creep)."""
        self.seen += 1
        baseline = self.ewma.update(float(value))
        if baseline is None or baseline <= 0 or self.seen <= self.warmup:
            return None
        rel_dev = (value - baseline) / baseline
        bad = rel_dev < -self.rel if self.direction == "drop" \
            else rel_dev > self.rel
        if not bad:
            return None
        return {"metric": self.metric, "value": float(value),
                "ewma": round(baseline, 6),
                "rel_dev": round(rel_dev, 4),
                "direction": self.direction}


class SentinelBank:
    """The task-level bundle: three sentinels + the flight ring.

    The train loop calls :meth:`observe_step` / :meth:`observe_round` /
    :meth:`observe_trace` with the SAME record dicts it emits to the
    sink, and :meth:`flight_dump` from its exception path.  Everything
    degrades to a no-op without an active sink (the lint pass warns at
    check time — sentinel thresholds require ``metrics_sink``)."""

    def __init__(self, metrics: Metrics, rel: float = 0.2,
                 warmup: int = 3, ring: int = 64, alpha: float = 0.3,
                 on_anomaly=None):
        if rel <= 0:
            # a zero/negative threshold fires on every post-warmup
            # observation — an anomaly-plus-flight storm, never intended
            from . import log
            log.warn(f"sentinel_rel={rel} must be > 0; using 0.2")
            rel = 0.2
        self.metrics = metrics
        # serving runs touch the ring from two threads at once: the
        # reporter appends serve_window records while the main thread's
        # abort path runs flight_dump BEFORE the reporter is joined —
        # list(ring)-during-append raises "deque mutated during
        # iteration" and costs the flight evidence at the worst moment
        self.ring: deque = deque(maxlen=max(int(ring), 1))  # racelint: guarded-by(self._lock)
        self._lock = threading.Lock()
        self.sentinels = {
            "examples_per_sec": Sentinel("examples_per_sec", "drop",
                                         rel, warmup, alpha),
            "comm_share": Sentinel("comm_share", "rise", rel, warmup,
                                   alpha),
            "hbm_peak_bytes": Sentinel("hbm_peak_bytes", "rise", rel,
                                       warmup, alpha),
            # serve-side sentinels (doc/serve.md): fed by the
            # ``serve_window`` records task_serve's reporter thread
            # emits — the serving-regression signal the
            # hot-swap/rollback machinery acts on
            "serve_p99_ms": Sentinel("serve_p99_ms", "rise", rel,
                                     warmup, alpha),
            "serve_qps": Sentinel("serve_qps", "drop", rel, warmup,
                                  alpha),
            "serve_queue_depth": Sentinel("serve_queue_depth", "rise",
                                          rel, warmup, alpha),
        }
        self.anomalies: List[Dict] = []  # racelint: guarded-by(self._lock)
        # optional anomaly callback (serve/admin.FlightCapture.trigger
        # rides here): called AFTER the anomaly/flight records land, so
        # a failing hook can never cost the primary evidence
        self.on_anomaly = on_anomaly

    # ---------------------------------------------------- resume state
    def state(self) -> Dict:
        """JSON-able resume state (the checkpoint manifest carries it):
        per-series EWMA mean + observation count, plus the flight ring.
        Without this a resumed run re-warms its baselines from scratch
        and the first post-resume rounds can neither fire nor extend a
        pre-kill trend."""
        with self._lock:
            ring = list(self.ring)
        return {"sentinels": {k: {"mean": s.ewma.mean, "seen": s.seen}
                              for k, s in self.sentinels.items()},
                "ring": ring}

    def set_state(self, st: Dict) -> None:
        for k, sv in (st.get("sentinels") or {}).items():
            s = self.sentinels.get(k)
            if s is None:
                continue
            mean = sv.get("mean")
            s.ewma.mean = None if mean is None else float(mean)
            s.seen = int(sv.get("seen", 0))
        with self._lock:
            for rec in st.get("ring") or []:
                self.ring.append(rec)

    # ------------------------------------------------------------ hooks
    def observe_step(self, rec: Dict, judge: bool = True) -> None:
        """One ``step`` record into the ring, and (unless ``judge`` is
        False: the window held work of the plane itself, a profiled
        dispatch or an extra monitor tick, that is no regression) its
        throughput into the sentinel."""
        with self._lock:
            self.ring.append(dict(rec, kind="step"))
        if judge and rec.get("examples_per_sec"):
            self._check("examples_per_sec", rec["examples_per_sec"], rec)

    def observe_round(self, rec: Dict) -> None:
        if rec.get("hbm_peak_bytes"):
            self._check("hbm_peak_bytes", rec["hbm_peak_bytes"], rec)

    def observe_trace(self, rec: Dict) -> None:
        if rec.get("comm_share"):
            self._check("comm_share", rec["comm_share"], rec)

    # racelint: thread(reporter)
    def observe_serve(self, rec: Dict) -> None:
        """One ``serve_window`` record: windowed p99 latency (rise),
        achieved QPS (drop), and live queue depth (rise).  Windows
        also enter the flight ring, so a serving anomaly dumps the
        windows leading into it.  A zero queue-depth baseline never
        fires (the Sentinel contract) — depth watching arms only once
        the server actually runs a standing queue."""
        with self._lock:
            self.ring.append(dict(rec, kind="serve_window"))
        if rec.get("p99_ms"):
            self._check("serve_p99_ms", rec["p99_ms"], rec)
        if rec.get("qps"):
            self._check("serve_qps", rec["qps"], rec)
        if rec.get("queue_depth") is not None:
            self._check("serve_queue_depth", rec["queue_depth"], rec)

    def _check(self, name: str, value: float, rec: Dict) -> None:
        hit = self.sentinels[name].observe(value)
        if hit is None:
            return
        for k in ("round", "step", "global_step", "window"):
            if k in rec:
                hit[k] = rec[k]
        with self._lock:
            self.anomalies.append(hit)
        self.metrics.counter_inc("anomalies")
        self.metrics.emit("anomaly", **hit)
        self.flight_dump(f"anomaly: {name} {hit['direction']} "
                         f"{hit['rel_dev']:+.0%} vs ewma")
        if self.on_anomaly is not None:
            try:
                self.on_anomaly(hit)
            except Exception as e:  # noqa: BLE001 — a capture-hook
                # failure must not kill the reporter thread
                from . import log
                log.warn(f"sentinel on_anomaly hook failed: {e}")

    # ------------------------------------------------------ flight ring
    def flight_dump(self, reason: str) -> None:
        """Dump (and clear) the step ring as one ``flight`` record.  An
        empty ring writes nothing — a TrainingDiverged on the very first
        monitored step has no history to preserve.  Snapshot-and-clear
        happens under the ring lock (the reporter may still be
        appending); the sink write runs outside it so slow disk never
        blocks the reporter's next window."""
        with self._lock:
            records = list(self.ring)
            self.ring.clear()
        if not records:
            return
        self.metrics.emit("flight", reason=reason,
                          n_records=len(records),
                          records=records)

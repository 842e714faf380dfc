"""Counters, gauges, latency histograms, a JSONL record sink and the
host span tracer (the JAX package's ``MetricsRegistry``).

``counter_inc`` / ``set_gauge`` / ``observe`` / ``emit``, and
``tracer`` (:class:`~.spans.SpanTracer`, armed by ``trace_sample``).
Records keep the JAX package's schema (``ts`` + ``kind`` + fields, one
JSON object per line) so the same readers take both.
:meth:`Metrics.snapshot` is what the admin endpoint's ``/metrics``
renders: counters and gauges read through :func:`copy_racy`, never
under the writers' lock.  :func:`device_memory_gauges` reads the caching
allocator's high-water and live bytes.
"""

from __future__ import annotations

import json
import math
import random
import threading
import time
from typing import Any, Dict, List, Optional


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a SORTED list: ceil(n*q/100)-1,
    clamped (the JAX package's definition)."""
    i = max(math.ceil(len(sorted_vals) * q / 100.0) - 1, 0)
    return sorted_vals[min(i, len(sorted_vals) - 1)]


def copy_racy(d: Dict, tries: int = 8) -> Dict:
    """Copy a dict another thread may be growing without locking the
    writer: a copy that meets an insert raises RuntimeError, so retry a
    few times, then copy item by item (the JAX package's
    ``serve/admin.copy_racy``)."""
    for _ in range(tries):
        try:
            return dict(d)
        except RuntimeError:
            continue
    out = {}
    for k in list(d.keys()):
        try:
            out[k] = d[k]
        except KeyError:
            continue
    return out


class Histogram:
    """Streaming summary (count / sum / min / max / last + p50 / p95 /
    p99), the JAX package's: percentiles come from a reservoir of at
    most ``_RESERVOIR`` values (exact until it fills, a uniform sample
    after, replaced from a fixed-seed generator so equal streams give
    equal summaries), so a long serve's ``/metrics`` scrape costs the
    same at every hour.  Thread-safe: one lock over the update."""

    _RESERVOIR = 2048

    __slots__ = ("count", "total", "min", "max", "last", "_samples",
                 "_rng", "_lock")

    def __init__(self):
        self.count = 0                        # racelint: guarded-by(self._lock)
        self.total = 0.0                      # racelint: guarded-by(self._lock)
        self.min: Optional[float] = None      # racelint: guarded-by(self._lock)
        self.max: Optional[float] = None      # racelint: guarded-by(self._lock)
        self.last: Optional[float] = None     # racelint: guarded-by(self._lock)
        self._samples: List[float] = []       # racelint: guarded-by(self._lock)
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    # racelint: thread(shared)
    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            if len(self._samples) < self._RESERVOIR:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._RESERVOIR:
                    self._samples[j] = v

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {"count": self.count, "sum": self.total}
            if self.count:
                s = sorted(self._samples)
                out.update(min=self.min, max=self.max,
                           mean=self.total / self.count, last=self.last,
                           p50=nearest_rank(s, 50), p95=nearest_rank(s, 95),
                           p99=nearest_rank(s, 99))
        return out


class Metrics:
    """Per-trainer instruments plus an optional ``jsonl:<path>`` sink."""

    def __init__(self):
        # racelint: atomic(per-key bumps under _lock in counter_inc; the scrape path reads via copy_racy)
        self.counters: Dict[str, int] = {}
        # racelint: atomic(per-key float store; scrape reads via copy_racy)
        self.gauges: Dict[str, float] = {}
        # racelint: atomic(per-key insert via setdefault; Histogram itself is internally locked)
        self.histograms: Dict[str, Histogram] = {}
        self.sink_path: Optional[str] = None
        self._fo = None  # racelint: guarded-by(self._lock)
        self._lock = threading.Lock()
        from .spans import SpanTracer
        self.tracer = SpanTracer(self)

    def configure_sink(self, spec: str) -> None:
        self.close()
        if not spec or spec in ("none", "0"):
            return
        if not spec.startswith("jsonl:"):
            raise ValueError(
                f"metrics_sink = {spec!r}: expected jsonl:<path> (or none)")
        self.sink_path = spec[len("jsonl:"):]
        # append-only record stream, flushed per record
        fo = open(self.sink_path, "a")  # disclint: ok(atomic-write)
        with self._lock:
            self._fo = fo

    def configure_tracer(self, sample: int) -> None:
        """``trace_sample = N``: span-trace every Nth request (0 off)."""
        self.tracer.configure(sample)

    @property
    def active(self) -> bool:
        with self._lock:
            return self._fo is not None

    # racelint: thread(shared)
    def counter_inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            return self.counters[name]

    # racelint: thread(shared)
    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # racelint: thread(shared)
    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms.setdefault(name, Histogram())
        h.observe(value)

    def snapshot(self) -> Dict[str, Any]:
        """Counters, gauges and histogram summaries, copied without the
        lock (the scrape path must not wait on the instruments)."""
        return {"counters": copy_racy(self.counters),
                "gauges": copy_racy(self.gauges),
                "histograms": {k: h.summary() for k, h
                               in copy_racy(self.histograms).items()}}

    # racelint: thread(shared)
    def emit(self, kind: str, **fields: Any) -> None:
        """Write one record (no-op without a sink)."""
        with self._lock:
            if self._fo is None:
                return
            rec = {"ts": round(time.time(), 3), "kind": kind}
            rec.update(fields)
            self._fo.write(json.dumps(rec, sort_keys=True, default=float)
                           + "\n")
            self._fo.flush()

    def close(self) -> None:
        with self._lock:
            fo, self._fo = self._fo, None
        if fo is not None:
            fo.close()


def device_memory_gauges(device) -> Dict[str, int]:
    """``hbm_peak_bytes`` / ``hbm_bytes_in_use`` of a CUDA ``device`` from
    the caching allocator (``max_memory_allocated`` / ``memory_allocated``);
    empty on the CPU, where the fields are left out rather than written
    as zeros."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return {}
    import torch
    return {"hbm_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "hbm_bytes_in_use": int(torch.cuda.memory_allocated(device))}

"""Host-side span tracing (the JAX package's ``monitor/spans.py``).

:class:`SpanTracer` emits named, timestamped spans on one monotonic
clock as ``span`` records through the :class:`~.metrics.Metrics` sink:
the micro-batcher's queue -> coalesce -> dispatch (pad / device /
unpad) -> respond chain, the step scheduler's prefill / decode / draft /
verify, the checkpoint writer and the device prefetcher.

* **Nothing when off.**  ``trace_sample = 0`` (the default): one int
  compare, then :meth:`SpanTracer.new_trace` returns ``None``,
  :meth:`SpanTracer.span` the shared no-op context manager and
  :meth:`SpanTracer.emit` returns before building anything.
* **Sampling.**  ``trace_sample = N`` traces every Nth request, decided
  once at :meth:`new_trace`; every later span of a request carries its
  ``trace_id`` or is skipped, so a sampled chain is always complete.
* **Cross-thread spans** take two ``time.perf_counter()`` stamps and the
  requester's thread name (``tid=``), whichever thread emits them.
* **Batch linking.**  A dispatch span carries ``riders`` (the sampled
  requests it served), and :meth:`link` hands that list thread-locally
  to the spans emitted inside it.

Record schema (doc/monitor.md): ``{"kind": "span", "span": <stage>,
"us": <start, us since the tracer epoch>, "dur_us": <int>, "tid":
<thread name>, "trace_id": <int>, "riders": [ids], ...attrs}``, read by
``tools/obsv.py`` (:func:`stage_decomposition`) and
``tools/spans2trace.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

#: request-path stage names in path order (doc/monitor.md "Reading a
#: p99 breakdown").  ``pad``/``device``/``unpad`` nest INSIDE
#: ``dispatch`` — shares are fractions of total request wall, so the
#: four top-level stages (queue_wait/coalesce/dispatch/respond) sum to
#: ~1.0 and the dispatch sub-stages re-decompose the dispatch share.
REQUEST_STAGES = ("queue_wait", "coalesce", "dispatch", "pad", "device",
                  "unpad", "respond")


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path
    allocates nothing (one module-level instance serves every call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context-manager form: stamps entry/exit and emits on exit."""

    __slots__ = ("tracer", "name", "trace_id", "attrs", "t0")

    def __init__(self, tracer: "SpanTracer", name: str,
                 trace_id: Optional[int], attrs: dict):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.emit(self.name, self.t0, time.perf_counter(),
                         trace_id=self.trace_id, **self.attrs)
        return False


class _Link:
    """Context manager installing a thread-local rider list: spans
    emitted inside (the engine's pad/device/unpad, which don't know
    which requests ride the batch) inherit it automatically."""

    __slots__ = ("tracer", "riders", "prev")

    def __init__(self, tracer: "SpanTracer", riders: Sequence[int]):
        self.tracer = tracer
        self.riders = list(riders)
        self.prev = None

    def __enter__(self):
        tls = self.tracer._tls
        self.prev = getattr(tls, "riders", None)
        tls.riders = self.riders
        return self

    def __exit__(self, *exc):
        self.tracer._tls.riders = self.prev
        return False


class SpanTracer:
    """Low-overhead host-side span tracer over a Metrics sink.

    One per registry (``Metrics.tracer``); disabled until
    ``trace_sample = N`` arms it AND the registry has an active sink
    (no sink, no records — same contract as every other record kind).
    """

    def __init__(self, metrics, sample: int = 0):
        self.metrics = metrics
        # racelint: atomic(int swap: the flight capture's reporter thread re-arms it; every reader reads it once per call)
        self.sample = int(sample)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        # last allocated trace_id
        self._next_id = 0  # racelint: guarded-by(self._lock)
        # requests offered to the sampler
        self._n_seen = 0   # racelint: guarded-by(self._lock)
        self._tls = threading.local()

    # ------------------------------------------------------------- state
    @property
    def enabled(self) -> bool:
        """True only when sampling is armed AND records can land."""
        return self.sample > 0 and self.metrics.active

    # racelint: thread(reporter)
    def configure(self, sample: int) -> None:
        """(Re)arm: ``trace_sample = N`` traces every Nth request,
        ``0`` disables.  The tracer object is stable so components that
        grabbed ``metrics.tracer`` early see the change; the flight
        capture re-arms it from the serve reporter's thread."""
        self.sample = int(sample)

    @property
    def watermark(self) -> int:
        """The last issued trace_id (an int read, no lock): two reads
        bracket the id range of the requests traced between them, which
        the flight capture's ``serve_flight`` record names
        (``trace_first`` / ``trace_last``)."""
        # racelint: ok(race_unguarded) — GIL-atomic int read; the flight heuristic tolerates a watermark one id stale
        return self._next_id

    # -------------------------------------------------------------- ids
    def new_trace(self) -> Optional[int]:
        """The per-request sampling decision: every ``sample``-th
        request gets a fresh, process-unique trace_id; the rest get
        ``None`` (and no downstream span touches them).  Thread-safe;
        near-free when disabled.  ``sample`` is read once: the flight
        capture's reporter thread may set it to 0 between two reads."""
        sample = self.sample
        if sample <= 0 or not self.metrics.active:
            return None
        with self._lock:
            n = self._n_seen
            self._n_seen += 1
            if n % sample:
                return None
            self._next_id += 1
            return self._next_id

    def sampled(self, n: int) -> bool:
        """Stateless sampling helper for non-request series (prefetch
        items, ...): does the caller's ``n``-th event fall on this
        tracer's sampling grid?  ``sample`` is read once, as in
        :meth:`new_trace`."""
        sample = self.sample
        return sample > 0 and n % sample == 0

    # ------------------------------------------------------------- emit
    def emit(self, name: str, t0: float, t1: float, *,
             trace_id: Optional[int] = None,
             riders: Optional[Sequence[int]] = None,
             tid: Optional[str] = None, **attrs) -> None:
        """One ``span`` record from two monotonic stamps.  ``tid``
        overrides the thread-name track for cross-thread spans (a
        queue-wait span belongs on the CLIENT's track even though the
        dispatcher emits it)."""
        if self.sample <= 0 or not self.metrics.active:
            return
        rec = {"span": name,
               "us": int((t0 - self._epoch) * 1e6),
               "dur_us": max(int((t1 - t0) * 1e6), 0),
               "tid": tid if tid is not None
               else threading.current_thread().name}
        if trace_id is not None:
            rec["trace_id"] = trace_id
        if riders is None:
            riders = getattr(self._tls, "riders", None)
        if riders:
            rec["riders"] = list(riders)
        rec.update(attrs)
        self.metrics.emit("span", **rec)

    def span(self, name: str, trace_id: Optional[int] = None, **attrs):
        """Context-manager span; returns the shared no-op when the
        tracer is disabled (zero allocation on the off path)."""
        if self.sample <= 0 or not self.metrics.active:
            return _NULL_SPAN
        return _Span(self, name, trace_id, attrs)

    # explicit begin/end for call sites where a context manager does
    # not fit (spans crossing function boundaries or threads)
    def begin(self, name: str, trace_id: Optional[int] = None, **attrs):
        """Returns an opaque token for :meth:`end`, or ``None`` when
        disabled (``end(None)`` is a no-op, so callers need no guard)."""
        if self.sample <= 0 or not self.metrics.active:
            return None
        return (name, time.perf_counter(), trace_id, attrs)

    def end(self, token) -> None:
        if token is None:
            return
        name, t0, trace_id, attrs = token
        self.emit(name, t0, time.perf_counter(), trace_id=trace_id,
                  **attrs)

    def link(self, riders: Sequence[int]):
        """Install ``riders`` thread-locally for spans emitted inside
        (see :class:`_Link`); no-op when disabled or empty."""
        if not riders or self.sample <= 0 or not self.metrics.active:
            return _NULL_SPAN
        return _Link(self, riders)

    def linked(self) -> Optional[List[int]]:
        """The rider list installed on THIS thread (``None`` outside a
        :meth:`link` block).  Dispatch sub-spans gate on it so an
        unsampled batch emits nothing — the sampling contract extends
        through the engine, not just the batcher."""
        return getattr(self._tls, "riders", None)


class NullTracer:
    """Tracer-shaped no-op for call sites without a registry (the
    ``tracer or spans.NULL`` idiom keeps their span code unguarded)."""

    sample = 0
    enabled = False
    watermark = 0

    def new_trace(self):
        return None

    def sampled(self, n: int) -> bool:
        return False

    def emit(self, *a, **k):
        return None

    def span(self, *a, **k):
        return _NULL_SPAN

    def begin(self, *a, **k):
        return None

    def end(self, token):
        return None

    def link(self, riders):
        return _NULL_SPAN

    def linked(self):
        return None


NULL = NullTracer()


# --------------------------------------------------------------- analysis

def span_records(records: Sequence[dict]) -> List[dict]:
    """Filter a record stream down to well-formed span records."""
    return [r for r in records
            if r.get("kind") == "span" and "span" in r and "dur_us" in r]


def stage_decomposition(records: Sequence[dict]) -> dict:
    """Per-stage request-path latency decomposition from span records
    (the table behind ``tools/obsv.py``'s serving section and
    ``bench.py --serve``'s per-point report).

    Per-request spans (carrying ``trace_id``) count once; batch-level
    spans (carrying ``riders``) count once PER RIDER — every rider
    experienced that dispatch's duration.  ``share`` is the stage's
    fraction of total request wall (the summed ``request`` spans, or
    the top-level stage total when none landed), so queue_wait +
    coalesce + dispatch + respond ≈ 1.0 and pad/device/unpad
    re-decompose the dispatch share.
    """
    per_stage: Dict[str, List[float]] = {}
    request_ms = 0.0
    n_requests = 0
    for r in span_records(records):
        name = r["span"]
        ms = r["dur_us"] / 1e3
        if name == "request":
            request_ms += ms
            n_requests += 1
            continue
        if name not in REQUEST_STAGES:
            continue
        weight = 1 if r.get("trace_id") is not None \
            else len(r.get("riders") or ())
        if weight <= 0:
            continue
        per_stage.setdefault(name, []).extend([ms] * weight)
    if not per_stage:
        return {"requests": n_requests, "stages": []}
    if request_ms <= 0.0:
        request_ms = sum(sum(v) for k, v in per_stage.items()
                         if k in ("queue_wait", "coalesce", "dispatch",
                                  "respond"))
    from .metrics import nearest_rank
    stages = []
    for name in REQUEST_STAGES:
        vals = per_stage.get(name)
        if not vals:
            continue
        vals.sort()

        def pct(q):
            return round(nearest_rank(vals, q), 3)

        total = sum(vals)
        stages.append({
            "stage": name, "count": len(vals),
            "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
            "total_ms": round(total, 3),
            "share": round(total / request_ms, 4) if request_ms else None,
        })
    return {"requests": n_requests, "stages": stages,
            "request_ms_total": round(request_ms, 3)}

"""The serve host's admin HTTP endpoint and the anomaly flight capture
(the JAX package's ``serve/admin.py``).

``serve_admin_port = N`` starts one stdlib ``http.server`` thread in the
serve task, owned by :class:`~.host.ModelHost` and joined last by its
``close()``:

* ``/metrics`` — the live :class:`~..monitor.metrics.Metrics` as
  Prometheus text (:mod:`..monitor.promtext`), with the batcher's batch
  sizes and the scheduler's occupancy as exact ``le``-bucket histograms;
* ``/healthz`` — 200 while the process serves;
* ``/readyz`` — 200 only while ``ModelHost.ready`` holds (every model
  warmed, zero retraces), 503 during warmup and from the first line of
  ``close()``;
* ``/statusz`` — JSON: uptime, ready, each model's counters, last
  reporter window and footprint, the config, the flights and the SLO
  verdict (:mod:`..monitor.slo`).

The scrape path takes neither the batcher's nor the scheduler's locks:
it reads plain ints, whole-object swaps (the last window, the SLO
verdict, the footprints) and :func:`copy_racy` copies of dicts the
dispatcher grows.

:class:`FlightCapture`: a sentinel anomaly or an SLO burn boosts
``trace_sample`` for the next ``serve_flight_requests`` requests, then
emits one ``serve_flight`` record with the recent ``serve_window`` ring
and the range of trace ids it boosted.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from ..monitor import log as mlog
from ..monitor import promtext
from ..monitor.metrics import copy_racy

__all__ = ["AdminServer", "FlightCapture", "copy_racy"]


class FlightCapture:
    """Anomaly-triggered span boost and one ``serve_flight`` record.

    :meth:`trigger` arms it (a no-op while armed, so a storm of
    anomalies makes one flight); :meth:`tick`, once a reporter window,
    completes it after ``requests`` boosted requests, or after
    ``max_ticks`` windows so that a host with no traffic still lands
    its record."""

    def __init__(self, metrics, count_fn: Callable[[], int], *,
                 model: str = "default", boost: int = 1,
                 requests: int = 16, max_ticks: int = 10, ring: int = 8,
                 stats_fn: Optional[Callable[[], dict]] = None):
        self.metrics = metrics
        self.count_fn = count_fn          # served requests, read lock-free
        self.model = model
        self.boost = max(1, int(boost))
        self.requests = max(1, int(requests))
        self.max_ticks = max(1, int(max_ticks))
        self.stats_fn = stats_fn
        # racelint: atomic(bounded deque, GIL-atomic appends; tick() snapshots under the arm lock and staleness is tolerated)
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._lock = threading.Lock()
        self.armed = False        # racelint: guarded-by(self._lock)
        self._reason = ""         # racelint: guarded-by(self._lock)
        self._prev_sample = 0     # racelint: guarded-by(self._lock)
        self._wm0 = 0             # racelint: guarded-by(self._lock)
        self._n0 = 0              # racelint: guarded-by(self._lock)
        self._ticks = 0           # racelint: guarded-by(self._lock)

    def note_window(self, rec: dict) -> None:
        """Keep the recent ``serve_window`` records (the flight's
        context; the sentinel bank's ring clears at each dump)."""
        self._ring.append(dict(rec))

    def trigger(self, reason: str) -> bool:
        """Arm the capture; False when it is armed already."""
        with self._lock:
            if self.armed:
                return False
            tracer = self.metrics.tracer
            self._prev_sample = tracer.sample
            self._wm0 = tracer.watermark
            self._n0 = self.count_fn()
            self._ticks = 0
            reason = str(reason)
            self._reason = reason
            self.armed = True
            tracer.configure(self.boost)
        mlog.info(f"serve flight armed ({reason}): trace_sample -> "
                  f"{self.boost} for next {self.requests} requests")
        return True

    # racelint: thread(reporter)
    def tick(self) -> Optional[dict]:
        """One reporter window; the ``serve_flight`` record when the
        capture completes in it, else None."""
        with self._lock:
            if not self.armed:
                return None
            self._ticks += 1
            boosted = self.count_fn() - self._n0
            if boosted < self.requests and self._ticks < self.max_ticks:
                return None
            tracer = self.metrics.tracer
            tracer.configure(self._prev_sample)
            wm1 = tracer.watermark
            rec: Dict[str, Any] = {
                "model": self.model, "reason": self._reason,
                "requests_boosted": int(boosted),
                "sample_boost": self.boost,
                "trace_first": self._wm0 + 1 if wm1 > self._wm0 else 0,
                "trace_last": wm1 if wm1 > self._wm0 else 0,
                "n_windows": len(self._ring),
                "windows": list(self._ring),
            }
            if self.stats_fn is not None:
                rec["stats"] = self.stats_fn()
            self.armed = False
        self.metrics.counter_inc("serve_flights")
        self.metrics.emit("serve_flight", **rec)
        mlog.info(f"serve flight captured: {rec['requests_boosted']} "
                  f"requests, traces {rec['trace_first']}.."
                  f"{rec['trace_last']} ({rec['reason']})")
        return rec


class AdminServer:
    """The four surfaces over one ``ThreadingHTTPServer``: daemon threads
    a request, one acceptor thread named ``cxxnet-serve-admin`` that
    :meth:`close` joins."""

    def __init__(self, host, metrics, *, port: int, addr: str = "0.0.0.0",
                 config: Optional[Dict[str, Any]] = None):
        self.host = host
        self.metrics = metrics
        self._addr = (addr, int(port))
        self._config = dict(config or {})
        self._t0 = time.time()
        # racelint: atomic(whole-object swap: start()/close() publish; the acceptor loop and port property only read)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # whole-object swaps the scrape path reads without locks
        # racelint: atomic(whole-object dict swap, reporter is the single writer; handlers read the old or the new map, never a torn one)
        self._last_window: Dict[str, dict] = {}
        # racelint: atomic(whole-object dict swap, note_ready is the single writer)
        self._footprints: Dict[str, dict] = {}
        self.slo = None          # SloTracker (task_serve wires it)
        self.flight: Optional[FlightCapture] = None

    # ------------------------------------------------------------ wiring
    def note_window(self, model: str, rec: dict) -> None:
        """A reporter tick: cache the window for ``/statusz`` (which must
        not drain ``window_stats``, the reporter's) and the flight's
        ring."""
        self._last_window = dict(self._last_window, **{model: dict(rec)})
        if self.flight is not None:
            self.flight.note_window(rec)

    def note_ready(self) -> None:
        """Cache each model's footprint at ready time (too heavy for a
        10 Hz scrape)."""
        try:
            self._footprints = {name: self.host.model(name).footprint()
                                for name in self.host.names}
        except Exception as e:  # noqa: BLE001 — status must not gate ready
            mlog.warn(f"admin: footprint cache failed: {e}")

    # ------------------------------------------------------------- server
    def start(self) -> int:
        """Bind and serve; returns the bound port (port 0 binds an
        ephemeral one)."""
        admin = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr line a request
                return

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    admin._route(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the scraper went away mid-response

        self._httpd = ThreadingHTTPServer(self._addr, _Handler)
        self._httpd.daemon_threads = True

        def _serve():
            try:
                self._httpd.serve_forever(poll_interval=0.1)
            except Exception as e:  # noqa: BLE001 — surface, never die
                mlog.warn(f"serve admin endpoint died: {e}")

        self._thread = threading.Thread(target=_serve, daemon=True,
                                        name="cxxnet-serve-admin")
        self._thread.start()
        mlog.info(f"serve admin endpoint on http://{self._addr[0]}:"
                  f"{self.port}/  (/metrics /healthz /readyz /statusz)")
        return self.port

    @property
    def port(self) -> int:
        assert self._httpd is not None, "call start() first"
        return self._httpd.server_address[1]

    def close(self) -> None:
        """Stop accepting and join the acceptor.  Idempotent."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ routing
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            body = self._metrics_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
            code = 200
        elif path == "/healthz":
            body, ctype, code = b"ok\n", "text/plain", 200
        elif path == "/readyz":
            ready = bool(self.host.ready)
            body = b"ready\n" if ready else b"not ready\n"
            ctype, code = "text/plain", (200 if ready else 503)
        elif path in ("/statusz", "/"):
            body = (json.dumps(self._statusz(), sort_keys=True,
                               default=repr) + "\n").encode()
            ctype, code = "application/json", 200
        else:
            body, ctype, code = b"not found\n", "text/plain", 404
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    # ------------------------------------------------------------ surfaces
    def _exact_hists(self) -> Dict[str, Dict[int, int]]:
        """Batch sizes and decode occupancy as exact ``le``-bucket
        histograms, summed over the hosted models."""
        hists: Dict[str, Dict[int, int]] = {}
        for name in self.host.names:
            m = self.host.model(name)
            for attr, hist, key in (("batcher", "batch_hist",
                                     "serve_batch_hist"),
                                    ("scheduler", "occ_hist",
                                     "decode_occupancy_hist")):
                front = getattr(m, attr, None)
                if front is None:
                    continue
                agg = hists.setdefault(key, {})
                for k, v in copy_racy(getattr(front, hist)).items():
                    agg[int(k)] = agg.get(int(k), 0) + int(v)
        return hists

    def _metrics_text(self) -> str:
        return promtext.render(self.metrics.snapshot(),
                               hists=self._exact_hists())

    def _model_status(self, name: str) -> Dict[str, Any]:
        m = self.host.model(name)
        out: Dict[str, Any] = {"retraces": int(m.retraces),
                               "dtype": m.cfg.dtype}
        win = self._last_window.get(name)
        if win is not None:
            out["last_window"] = win
        fp = self._footprints.get(name)
        if fp:
            out["footprint"] = fp
        bat = getattr(m, "batcher", None)
        if bat is not None:
            n_b = bat.n_batches
            out.update(
                kind="predict", requests=bat.n_requests, batches=n_b,
                rows=bat.rows_served,
                mean_batch=round(bat.rows_served / n_b, 2) if n_b else 0.0,
                batch_hist={str(k): v for k, v in sorted(
                    copy_racy(bat.batch_hist).items())},
                queue_depth_max=bat.depth_max)
        sched = getattr(m, "scheduler", None)
        if sched is not None:
            occ = copy_racy(sched.occ_hist)
            tot = sum(occ.values())
            out.update(
                kind="generate", requests=sched.n_requests,
                tokens=sched.n_tokens, steps=sched.n_steps,
                prefills=sched.n_prefills,
                mean_occupancy=round(sum(k * v for k, v in occ.items())
                                     / tot, 2) if tot else 0.0,
                occupancy_hist={str(k): v for k, v in sorted(occ.items())})
        eng_stats = getattr(m.engine, "stats", None)
        if eng_stats is not None and (bat is not None or sched is not None):
            out["engine"] = eng_stats()
        return out

    def _statusz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "uptime_sec": round(time.time() - self._t0, 3),
            "ready": bool(self.host.ready),
            "models": {name: self._model_status(name)
                       for name in self.host.names},
            "config": self._config,
            "flights": self.metrics.counters.get("serve_flights", 0),
        }
        slo = self.slo
        if slo is not None:
            out["slo"] = slo.verdict
        return out

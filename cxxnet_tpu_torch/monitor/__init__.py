"""Telemetry: structured records, the in-step norm monitor, host spans,
profile windows with layer attribution, sentinels and the goodput
ledger (the JAX package's ``monitor`` package; doc/monitor.md).

* :mod:`.log` — the CLI's line formats behind stdlib logging;
* :mod:`.metrics` — counters, gauges, histograms, the JSONL sink, the
  span tracer and the device memory gauges;
* :mod:`.spans` — host-side span tracing (``trace_sample``);
* :mod:`.ingraph` — per-leaf weight / grad / update norms (``monitor``);
* :mod:`.trace` — the profile window over ``torch.profiler`` and a
  reader of its Chrome-trace JSON (the ``trace`` record);
* :mod:`.attribution` — device time per connection (``layer_profile``);
* :mod:`.sentinel` — EWMA regression sentinels and the flight ring;
* :mod:`.promtext` — the Prometheus text of ``/metrics`` (serve/admin.py);
* :mod:`.slo` — SLO burn-rate tiers over the ``serve_window`` records;
* :mod:`.ledger` / :mod:`.diff` — the goodput ledger and the run
  comparator that ``tools/obsv.py`` renders.
"""

from __future__ import annotations


class TrainingDiverged(RuntimeError):
    """Raised by the NaN/inf loss guard under ``monitor_nan = fatal``."""


__all__ = ["TrainingDiverged"]

"""SLO burn-rate alerting over the ``serve_window`` record stream (the
JAX package's ``monitor/slo.py``).

The serve sentinels (:mod:`.sentinel`) detect change; an SLO is an
absolute target: ``serve_slo_p99_ms`` (a latency threshold) and
``serve_slo_avail`` (the fraction of requests that must meet it), whose
error budget ``1 - avail`` every request over the threshold spends.
``burn = error_rate / budget``: 1.0 spends the budget exactly over the
SLO period, 14.4 a 30-day budget in 2 days.

Two windows, rings of ``serve_window`` records (one a
``serve_sentinel_window``): the fast one (``serve_slo_fast_sec``,
threshold ``serve_slo_fast_burn``) catches an acute outage, the slow one
(``serve_slo_slow_sec``, ``serve_slo_slow_burn``) a simmering
regression.  The threshold crossing is judged by :func:`.diff.compare`,
the one comparison engine.  A tier emits one ``slo`` record on its
rising edge and holds ``firing`` until the burn falls back; the latest
verdict is swapped in whole, so ``/statusz`` reads it without a lock.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Dict, Optional

from .diff import LOWER_BETTER, compare


@dataclasses.dataclass
class SloSpec:
    """The declared serving SLO (from :class:`~..serve.ServeConfig`)."""

    p99_ms: float = 0.0        # latency threshold; 0 disables the SLO
    avail: float = 0.999       # fraction of requests under threshold
    fast_sec: float = 60.0     # acute window
    slow_sec: float = 600.0    # simmering window
    fast_burn: float = 14.4    # firing threshold, fast tier
    slow_burn: float = 6.0     # firing threshold, slow tier

    def __post_init__(self):
        if self.p99_ms > 0.0 and not (0.0 < self.avail < 1.0):
            raise ValueError(
                f"serve_slo_avail = {self.avail}: must be in (0, 1) — "
                "1.0 leaves a zero error budget, which no burn rate "
                "can be computed against")
        if self.fast_sec <= 0 or self.slow_sec <= 0:
            raise ValueError("SLO burn windows must be > 0 seconds")

    @property
    def active(self) -> bool:
        return self.p99_ms > 0.0

    @property
    def budget(self) -> float:
        return 1.0 - self.avail


class SloTracker:
    """Feed :meth:`observe` one ``serve_window`` record per reporter
    tick; it maintains both burn windows, emits ``slo`` records on
    rising edges, and keeps the latest verdict for ``/statusz``.

    The record must carry ``requests`` and ``viol`` (requests whose
    latency exceeded ``p99_ms`` — the batcher counts them per window
    when armed with ``slo_ms``); ``window_sec`` sizes the rings on
    first observation.
    """

    def __init__(self, spec: SloSpec, window_sec: float, *,
                 metrics=None, model: str = "default",
                 on_burn: Optional[Callable[[dict], Any]] = None):
        self.spec = spec
        self.metrics = metrics
        self.model = model
        self.on_burn = on_burn
        win = max(float(window_sec), 1e-9)
        self._tiers: Dict[str, dict] = {}
        for tier, sec, thresh in (
                ("fast", spec.fast_sec, spec.fast_burn),
                ("slow", spec.slow_sec, spec.slow_burn)):
            n = max(1, int(math.ceil(sec / win - 1e-9)))
            self._tiers[tier] = {
                "sec": sec, "threshold": thresh, "firing": False,
                "ring": deque(maxlen=n), "burn": 0.0}
        # latest verdict, swapped whole so /statusz reads it lock-free
        self.verdict: Dict[str, Any] = self._verdict()

    # ------------------------------------------------------------ observe
    def observe(self, rec: Dict[str, Any]) -> Optional[dict]:
        """One reporter window.  Returns the ``slo`` record dict when a
        tier crosses onto firing this tick (the flight-capture trigger),
        else None."""
        if not self.spec.active:
            return None
        requests = int(rec.get("requests", 0))
        viol = int(rec.get("viol", 0))
        fired: Optional[dict] = None
        for tier, st in self._tiers.items():
            st["ring"].append((requests, viol))
            total = sum(r for r, _ in st["ring"])
            bad = sum(v for _, v in st["ring"])
            error_rate = bad / total if total else 0.0
            burn = error_rate / self.spec.budget
            st["burn"] = burn
            # the ONE comparison engine judges the threshold crossing:
            # candidate burn vs the declared ceiling, LOWER_BETTER,
            # zero tolerance (any excursion past the ceiling regresses)
            judge = compare(f"slo_{tier}_burn", a=st["threshold"],
                            b=burn, rel=0.0, direction=LOWER_BETTER)
            now_firing = bool(judge["regressed"])
            if now_firing and not st["firing"]:
                out = {"model": self.model, "tier": tier,
                       "burn": round(burn, 4),
                       "threshold": st["threshold"],
                       "budget": self.spec.budget,
                       "error_rate": round(error_rate, 6),
                       "requests": total, "viol": bad,
                       "window_sec": st["sec"],
                       "rel_delta": judge["rel_delta"]}
                if self.metrics is not None:
                    self.metrics.counter_inc("slo_burns")
                    self.metrics.emit("slo", **out)
                if fired is None:
                    fired = out
            st["firing"] = now_firing
        self.verdict = self._verdict()
        if fired is not None and self.on_burn is not None:
            self.on_burn(fired)
        return fired

    # ------------------------------------------------------------ verdict
    def _verdict(self) -> Dict[str, Any]:
        tiers = {tier: {"burn": round(st["burn"], 4),
                        "threshold": st["threshold"],
                        "window_sec": st["sec"],
                        "firing": st["firing"]}
                 for tier, st in self._tiers.items()}
        return {"active": self.spec.active,
                "p99_ms_target": self.spec.p99_ms,
                "avail_target": self.spec.avail,
                "budget": self.spec.budget,
                "ok": not any(t["firing"] for t in tiers.values()),
                **tiers}

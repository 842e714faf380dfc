"""The benchmark's own spans around its calls into the program (the
prefetcher's ``next``, ``NetTrainer.update`` / ``predict_raw``): host
seconds and calls a span name, and in a traced run each span's
interval on the host clock (the trace reader names the device's idle
gaps by them)."""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from contextlib import contextmanager


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds = defaultdict(float)
        self.calls = Counter()
        #: (name, start, end) in ``time.perf_counter`` seconds
        self.intervals = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.seconds[name] += t1 - t0
            self.calls[name] += 1
            if self.traced:
                self.intervals.append((name, t0, t1))

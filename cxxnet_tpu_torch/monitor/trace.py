"""Profile windows over ``torch.profiler`` and a reader of their traces
(the JAX package's ``monitor/trace.py``).

:class:`ProfileWindow` opens ``torch.profiler.profile`` (CUDA and CPU
activity on the card, CPU activity on the CPU) around a span of train
dispatches and writes the window's Chrome-trace JSON to
``<prof>/trace.json`` (``<prof>/rNNNN/trace.json`` for recurring
windows).  While it is open the network enters a ``record_function``
range per connection (``Network.profile_scopes``), the names layer
attribution (:mod:`.attribution`) joins kernels against.

The reader imports no torch, as the JAX package's xplane reader imports
no jax: :func:`load_trace` reads a window's complete events,
:func:`comm_report_in` folds them into the ``trace`` record
(``device_sec``: the union of the device's busy intervals per dispatch;
``comm_sec`` / ``comm_share`` / ``overlap_frac`` / ``comm_by_kind``: the
NCCL kernels, classified by family, which read 0 on one card).  On the
CPU, where there are no device events, the timeline is the outermost
CPU ops of every thread.

The profiler can lose device events.  A window opens with a burst of
throwaway launches and then a ``record_function`` range
(:data:`WINDOW_RANGE`) that :func:`window_events` cuts the trace to,
so a loss of the profiler's first events falls on the burst.
:func:`kernel_shortfall` holds
the trace's events of each hand-written kernel against the launches its
wrappers counted while the window was open (``ops.WRAPPERS`` names the
kernels each launch puts on the card, a flash backward three, a
layernorm backward two); a window short of any must not report a
device time.
"""

from __future__ import annotations

import json
import os
import re
import time
from bisect import bisect_right
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: event categories that are device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of the host calls that launch device work (their
#: ``correlation`` names the device event)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: the ``record_function`` range around a window's dispatches; the
#: reader keeps what was launched inside it (:func:`window_events`)
WINDOW_RANGE = "profile_window"
#: throwaway launches on the card between the profiler's start and the
#: window's range: in some processes the profiler drops the device events
#: of the first launches it sees (on an H100, the first 17-19, ~2 ms,
#: late in a long run), so these take that loss instead of the window
WARMUP_LAUNCHES = 128

_NCCL_KIND = (("AllReduce", "all-reduce"), ("ReduceScatter", "reduce-scatter"),
              ("AllGather", "all-gather"), ("AllToAll", "all-to-all"),
              ("SendRecv", "collective-permute"), ("Send", "collective-permute"),
              ("Recv", "collective-permute"), ("Broadcast", "broadcast"),
              ("Reduce", "reduce"))


# ------------------------------------------------------------------ reading

def load_trace(path: str) -> List[dict]:
    """The complete (``ph == "X"``) events of a Chrome-trace JSON file,
    each with float ``ts`` / ``dur`` in microseconds."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    out = []
    for e in evs:
        if not isinstance(e, dict) or e.get("ph") != "X" or "ts" not in e:
            continue
        e["ts"] = float(e["ts"])
        e["dur"] = float(e.get("dur", 0.0) or 0.0)
        out.append(e)
    return out


def collective_kind(name: str) -> Optional[str]:
    """The collective family of an NCCL kernel (``ncclKernel_*`` /
    ``ncclDevKernel_*``), None for any other kernel."""
    if "nccl" not in name.lower():
        return None
    for key, kind in _NCCL_KIND:
        if key in name:
            return kind
    return "other"


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in _merged(intervals))


def _merged(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted, disjoint
    ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_us(iv: Tuple[float, float], merged, starts) -> float:
    """Length of ``iv`` covered by the sorted, disjoint ``merged``."""
    a, b = iv
    i = max(bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(a, merged[i][0]), min(b, merged[i][1])
        if hi > lo:
            got += hi - lo
        i += 1
    return got


def device_events(events: Sequence[dict]) -> List[dict]:
    """The device's events (kernels, copies, fills)."""
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def outermost_cpu_ops(events: Sequence[dict]) -> List[dict]:
    """CPU ops not nested in another CPU op of their thread: the CPU's
    op timeline, each op counted once."""
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for ops in by_thread.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = None
        for e in ops:
            if end is None or e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def timeline(events: Sequence[dict]) -> Tuple[List[dict], bool]:
    """``(events, on_device)``: the device's events, or on a CPU-only
    trace the outermost CPU ops."""
    dev = device_events(events)
    if dev:
        return dev, True
    return outermost_cpu_ops(events), False


def comm_report_in(events: Sequence[dict], steps: int = 1) -> Dict[str, object]:
    """The ``trace`` record of one window (doc/monitor.md): per dispatch,
    ``device_sec`` (the union of the timeline's busy intervals),
    ``comm_sec`` (the collectives' summed wall), ``comm_share``
    (comm / device), ``overlap_frac`` (the share of collective wall that
    compute covered) and ``comm_by_kind`` (ms per family)."""
    steps = max(int(steps), 1)
    tl, _ = timeline(events)
    busy = union_us((e["ts"], e["ts"] + e["dur"]) for e in tl)
    comm_us = exposed_us = 0.0
    by_kind: Dict[str, float] = {}
    comm = [(collective_kind(e.get("name", "")), e) for e in tl]
    compute = _merged((e["ts"], e["ts"] + e["dur"])
                      for k, e in comm if k is None)
    starts = [a for a, _ in compute]
    for kind, e in comm:
        if kind is None:
            continue
        iv = (e["ts"], e["ts"] + e["dur"])
        comm_us += e["dur"]
        exposed_us += e["dur"] - _overlap_us(iv, compute, starts)
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"]
    frac = 0.0
    if comm_us > 0:
        frac = min(max(1.0 - exposed_us / comm_us, 0.0), 1.0)
    return {
        "steps": steps,
        "device_sec": round(busy / 1e6 / steps, 6),
        "comm_sec": round(comm_us / 1e6 / steps, 6),
        "comm_share": round(comm_us / busy, 4) if busy else 0.0,
        "overlap_frac": round(frac, 4),
        "comm_by_kind": {k: round(us / 1e3 / steps, 3)
                         for k, us in by_kind.items()},
    }


def window_events(events: Sequence[dict]) -> List[dict]:
    """The events of a trace that the window's range
    (:data:`WINDOW_RANGE`) holds: a device event by the time of the host
    call that launched it (its ``correlation``), any other by its own
    start.  A trace without the range is returned whole."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW_RANGE]
    if not marks:
        return list(events)
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    launch = {(e.get("args") or {}).get("correlation"): e["ts"]
              for e in events if e.get("cat") in LAUNCH_CATS}
    out = []
    for e in events:
        t = e["ts"]
        if e.get("cat") in DEVICE_CATS:
            t = launch.get((e.get("args") or {}).get("correlation"), t)
        if lo <= t <= hi and e.get("name") != WINDOW_RANGE:
            out.append(e)
    return out


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd_wgmma_kernel<...>(...)``
    -> ``flash_fwd_wgmma_kernel``: the first identifier followed by its
    template or argument list once the return type and the anonymous
    namespace are dropped (the whole name when there is none)."""
    bare = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                                 ""))
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", bare)
    return m.group(1) if m else name


def kernel_shortfall(events: Sequence[dict], launches: Dict[str, int]
                     ) -> Dict[str, Tuple[int, int]]:
    """The hand-written kernels a trace holds fewer events of than the
    window launched: ``{names: (launched, seen)}``, keyed by the kernel's
    ``__global__`` names joined with ``|``.  ``launches`` is ``{wrapper:
    launches}`` of the window; ``ops.WRAPPERS`` names the kernels each
    launch puts on the card exactly once, so a wrapper is held to each
    of its kernels, and wrappers that share a kernel to their summed
    launches.  Empty: no event was lost."""
    from ..ops import WRAPPERS
    want: Dict[tuple, int] = {}
    for _, fn, kernels in WRAPPERS:
        for names in kernels:
            want[names] = want.get(names, 0) + int(launches.get(fn, 0))
    seen = Counter(kernel_base(e.get("name", "")) for e in events
                   if e.get("cat") == "kernel")
    out = {}
    for names, n in want.items():
        got = sum(seen[k] for k in names)
        if got < n:
            out["|".join(names)] = (n, got)
    return out


# ------------------------------------------------------------ the window

def _launch_counts() -> Dict[str, int]:
    from ..ops import launch_counts
    return launch_counts()


class ProfileWindow:
    """A profiler window over the train loop (doc/monitor.md ``prof*``).

    ``prof_start_step >= 0``: the window opens before that dispatch
    (dispatches counted across rounds from 0; a ``batch_split`` chain is
    one) and runs ``prof_num_steps`` dispatches (0: to the round's end).
    The default ``-1`` opens it at the start of the round past the first
    dispatch's warm-up (the second round, or the only one).  ``every =
    N`` (``prof_every``) opens a fresh window every Nth round from there,
    each under ``<trace_dir>/rNNNN``.  A closed window leaves its
    directory, dispatches and kernel launches (``{wrapper: n}``) in
    ``last_window_dir`` / ``last_window_steps`` / ``last_launches``, its
    trace file in ``last_trace``, and its profiler in
    ``last_profiler``.  ``net`` (a
    :class:`~..nnet.net.Network`) enters its per-connection ranges while
    the window is open.  Every hook is a no-op without ``trace_dir``."""

    def __init__(self, trace_dir: str, start_step: int = -1,
                 num_steps: int = 0, every: int = 0, net=None,
                 device=None):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.every = every
        self.net = net
        self.device = device
        self.active = False
        self.done = False
        self._steps_traced = 0
        self._prof = None
        self._range = None
        self._where = ""
        self._launches0: Dict[str, int] = {}
        self.last_window_dir = ""
        self.last_window_steps = 0
        self.last_launches: Dict[str, int] = {}
        self.last_trace = ""
        self.last_profiler = None

    def _start(self, where: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if getattr(self.device, "type", "cpu") == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.start()
        if len(acts) > 1:
            x = torch.zeros(1, device=self.device)
            for i in range(WARMUP_LAUNCHES):
                x.add_(1)
                if i == WARMUP_LAUNCHES // 2:
                    torch.cuda.synchronize(self.device)
                    time.sleep(0.005)
            torch.cuda.synchronize(self.device)
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        if self.net is not None:
            self.net.profile_scopes = True
        self._launches0 = _launch_counts()
        self._where = where
        self.active = True
        self._steps_traced = 0

    def maybe_start_round(self, rounds_done: int, prof_round: int) -> None:
        """Round-boundary hook of the whole-round windows (one-shot and
        ``prof_every``)."""
        if not self.trace_dir or self.start_step >= 0 or self.active:
            return
        if self.every > 0:
            if rounds_done >= prof_round \
                    and (rounds_done - prof_round) % self.every == 0:
                self._start(os.path.join(self.trace_dir,
                                         f"r{rounds_done:04d}"))
        elif not self.done and rounds_done == prof_round:
            self._start(self.trace_dir)

    def maybe_start_step(self, global_step: int) -> None:
        """Pre-dispatch hook: opens a step-addressed window."""
        if (self.trace_dir and self.start_step >= 0 and not self.done
                and not self.active and global_step >= self.start_step):
            self._start(self.trace_dir)

    def after_step(self) -> bool:
        """Post-dispatch hook; True when this dispatch closed the window
        (the caller then emits the reports)."""
        if not self.active:
            return False
        self._steps_traced += 1
        if self.num_steps and self._steps_traced >= self.num_steps:
            self.stop()
            return True
        return False

    def round_end(self) -> bool:
        """Round-boundary hook; an unbounded window closes here."""
        if self.active and not self.num_steps:
            self.stop()
            return True
        return False

    def stop(self) -> None:
        """Close the window: the device drained, the profiler stopped, the
        ranges off, the trace written."""
        import torch
        if getattr(self.device, "type", "cpu") == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self._range = None
        prof, self._prof = self._prof, None
        self.active = False
        if self.net is not None:
            self.net.profile_scopes = False
        prof.stop()
        now = _launch_counts()
        self.last_launches = {k: n - self._launches0.get(k, 0)
                              for k, n in now.items()}
        self.last_window_steps = self._steps_traced
        self.last_window_dir = self._where
        os.makedirs(self._where, exist_ok=True)
        self.last_trace = os.path.join(self._where, "trace.json")
        prof.export_chrome_trace(self.last_trace)
        self.last_profiler = prof
        if not self.every:
            self.done = True

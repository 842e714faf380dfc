"""Reading a ``torch.profiler`` window: the device's events, their union,
the window the benchmark marked, the hand-written kernels' events held
against the launch counters, and the busy / idle split.

The interval arithmetic (:func:`union_us`, :func:`merged`),
:func:`kernel_base`
and :func:`kernel_shortfall` are frozen copies of
``cxxnet_tpu_torch/monitor/trace.py``; the wrapper-to-kernel table the
shortfall check reads is passed in (the program's ``ops.WRAPPERS``).
The burst of throwaway launches before a window (:func:`warm_profiler`)
is that file's ``WARMUP_LAUNCHES`` guard: the profiler can drop the
device events of the first launches it sees.  The traced part is cut by
two marker kernels (:func:`mark`), each launched once the card has
drained, so a trace without host operations is cut as well; the first
marker's host time ties the benchmark's host spans to the trace's
clock.

Nothing here imports the program; torch only inside the functions that
drive the profiler.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from collections import Counter
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WARMUP_LAUNCHES = 128
#: the marker kernel (``torch.cuda._sleep``) launched at each end of the
#: traced part, after the card has drained
MARKER = "spin_kernel"
MARKER_CYCLES = 1000


def load_trace(path: str) -> List[dict]:
    """The complete (``ph == "X"``) events of a Chrome-trace JSON file,
    ``ts`` / ``dur`` as float microseconds."""
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


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in merged(intervals))


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """Intervals cut to ``[lo, hi]``; empty ones dropped."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def device_events(events: Sequence[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def launch_times(events: Sequence[dict]) -> Dict[object, float]:
    """Correlation id -> the host time of the call that launched it."""
    return {(e.get("args") or {}).get("correlation"): e["ts"]
            for e in events if e.get("cat") in LAUNCH_CATS}


def is_marker(e: dict) -> bool:
    return e.get("cat") == "kernel" and kernel_base(e.get("name", "")) \
        == MARKER


def marked_window(events: Sequence[dict]
                  ) -> Tuple[float, float, List[dict]]:
    """``(lo, hi, events)``: the traced part between the first and the
    last marker kernel (trace microseconds; the card was drained before
    each), and the events that start inside it, the markers left out."""
    marks = sorted(e["ts"] for e in events if is_marker(e))
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels "
                           f"({MARKER}), 2 expected")
    lo, hi = marks[0], marks[-1]
    return lo, hi, [e for e in events if lo <= e["ts"] <= hi
                    and not is_marker(e)]


@lru_cache(maxsize=4096)
def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd_wgmma_kernel<...>(...)``
    -> ``flash_fwd_wgmma_kernel``: the first identifier followed by its
    template or argument list once the return type and the anonymous
    namespace are dropped (the whole name when there is none).  The
    rule of the copied ``kernel_base``, found by a scan from each bracket
    rather than a backtracking regex, which takes time quadratic in the
    length of a mangled library kernel's name (thousands of characters,
    no bracket)."""
    bare = name.replace("(anonymous namespace)::", "")
    if bare.startswith("void "):
        bare = bare[5:]
    for i, ch in enumerate(bare):
        if ch not in "<(":
            continue
        j = i
        while j > 0 and bare[j - 1] == " ":
            j -= 1
        k = j
        while k > 0 and (bare[k - 1].isalnum() or bare[k - 1] == "_"):
            k -= 1
        while k < j and bare[k].isdigit():
            k += 1
        if k < j:
            return bare[k:j]
    return name


def kernel_shortfall(events: Sequence[dict], launches: Dict[str, int],
                     wrappers) -> Dict[str, Tuple[int, int]]:
    """The hand-written kernels a trace holds fewer events of than the
    window launched: ``{names: (launched, seen)}``.  ``wrappers`` is the
    program's ``(module, wrapper, kernels)`` table: each tuple of
    ``kernels`` is put on the card once a launch."""
    want: Dict[tuple, int] = {}
    for _, fn, kernels in wrappers:
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


def kernel_names(wrappers, wanted: Sequence[str]) -> set:
    """Every ``__global__`` name the wrappers ``wanted`` may launch."""
    out = set()
    for _, fn, kernels in wrappers:
        if fn in wanted:
            for names in kernels:
                out.update(names)
    return out


def kernel_us(events: Sequence[dict], names: set) -> float:
    """Summed duration of the kernels whose base name is in ``names``."""
    return sum(e["dur"] for e in events if e.get("cat") == "kernel"
               and kernel_base(e.get("name", "")) in names)


def device_ops(events: Sequence[dict], top: int = 10
               ) -> List[Tuple[str, float]]:
    """The device operations that took most time: [name, seconds]."""
    by = Counter()
    for e in device_events(events):
        by[kernel_base(e.get("name", "")) if e.get("cat") == "kernel"
           else e.get("name", e.get("cat"))] += e["dur"]
    return [[k, v / 1e6] for k, v in by.most_common(top)]


def busy_idle(events: Sequence[dict], lo: float, hi: float,
              spans: Sequence[Tuple[float, float, str]], top: int = 10
              ) -> Dict[str, object]:
    """Busy seconds of the device inside ``[lo, hi]``, and the longest
    idle gaps there, each named by the benchmark span the host was in at
    the gap's start (``spans``: (start, end, name) in trace
    microseconds, one after another)."""
    busy = merged(clip(((e["ts"], e["ts"] + e["dur"])
                        for e in device_events(events)), lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    sp = sorted(spans)
    starts = [x[0] for x in sp]

    def host_at(t0: float) -> str:
        # the benchmark's spans follow one another on one thread
        i = bisect_right(starts, t0) - 1
        if i >= 0 and t0 < sp[i][1]:
            return sp[i][2]
        return "between_spans"
    named = sorted(((b - a, host_at(a)) for a, b in gaps), reverse=True)
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "idle_gaps": [[name, d / 1e6] for d, name in named[:top]]}


def in_ranges_us(events: Sequence[dict], range_name: str) -> float:
    """Summed device time of the events launched inside the host ranges
    (user annotations) named ``range_name``."""
    rng = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == range_name)
    if not rng:
        return 0.0
    starts = [a for a, _ in rng]
    launch = launch_times(events)
    total = 0.0
    for e in device_events(events):
        t = launch.get((e.get("args") or {}).get("correlation"))
        if t is None:
            continue
        i = bisect_right(starts, t) - 1
        if i >= 0 and rng[i][0] <= t <= rng[i][1]:
            total += e["dur"]
    return total


def warm_profiler(device) -> None:
    """Throwaway launches after the profiler's start (the frozen
    ``WARMUP_LAUNCHES`` guard)."""
    import time

    import torch
    x = torch.zeros(1, device=device)
    for i in range(WARMUP_LAUNCHES):
        x.add_(1)
        if i == WARMUP_LAUNCHES // 2:
            torch.cuda.synchronize(device)
            time.sleep(0.005)
    torch.cuda.synchronize(device)


def mark(device) -> float:
    """Drain the card, then launch a marker kernel; returns the host
    clock (``time.perf_counter``) just before the launch."""
    import time

    import torch
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    return t

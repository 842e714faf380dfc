"""One run of one cell: find its pieces by name, set the program up
through the cell's driver, measure the window, read the per-layer
metrics from the trace in a traced run, judge what the timed path
produced against the plain reference, and print the result's line.

A driver module (``drivers/<name>.py``) has three functions of a
:class:`Run`: ``setup`` (build the program, drive its first steps for the
check, warm every shape the window uses), ``window`` (measure for
``run.seconds``; set ``run.e2e`` and ``run.attempted`` / ``run.failed``)
and ``judge`` (free the program, run the reference, ``run.check`` each
number compared with its limit).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Optional

from . import arith, spec as speclib, trace as tracelib
from .spans import Spans

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cxxnet_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names ``sys.modules`` holds, compared whole
    (``cxxnet_tpu_torch`` is not ``cxxnet_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Run:
    """What the harness, the cell's driver and the metric readers share."""

    def __init__(self, bench: speclib.Benchmark, cell_name: str, seed: int,
                 seconds: float, traced: bool, device, t_start: float):
        self.bench = bench
        self.cell = bench.cell(cell_name)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.limits = bench.limits(cell_name)
        self.reference = bench.reference(self.config["family"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(traced)
        self.device = device
        self.t_start = t_start
        self.tmp = os.environ.get("TMPDIR") or "/tmp"
        self.spans = Spans(traced)
        self.arith = arith
        # set by the driver
        self.e2e: Dict[str, float] = {}
        self.info: Dict[str, object] = {}
        self.attempted = 0
        self.failed = 0
        self.checks: Dict[str, tuple] = {}
        self.setup_s: Optional[float] = None
        # set by the trace
        self.events = None
        self.trace_summary: Dict[str, object] = {}
        self.launches: Dict[str, int] = {}
        self.traced_steps = 0
        self._prof = None
        self._t0_host = 0.0
        self._launches0: Dict[str, int] = {}
        # (set-up step, host clock at its end)
        self.marks = [("imports", time.perf_counter())]

    def mark(self, name: str) -> None:
        """The end of a set-up step (printed with its seconds)."""
        self.marks.append((name, time.perf_counter()))

    # ------------------------------------------------------------ checks
    def check(self, name: str, value: float, limit: float) -> None:
        """One number compared with its limit: passes when finite and not
        above the limit."""
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())

    # ------------------------------------------------------------- trace
    def begin_trace(self) -> None:
        """Start the profiler (device activity; host operations too where
        the mix asks, for metrics that read the program's ranges), take
        the throwaway launches, and mark the traced part's start."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        from cxxnet_tpu_torch.ops import launch_counts
        acts = [ProfilerActivity.CUDA]
        if self.traffic.get("trace_host_ops"):
            acts.append(ProfilerActivity.CPU)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.start()
        tracelib.warm_profiler(self.device)
        self._launches0 = launch_counts()
        self._t0_host = tracelib.mark(self.device)

    def end_trace(self, steps: int) -> None:
        """Close the traced part after ``steps`` steps or batches: drain
        the card, mark the end, stop the profiler and read its trace
        (once)."""
        if self._prof is None:
            return
        from cxxnet_tpu_torch.ops import WRAPPERS, launch_counts
        tracelib.mark(self.device)
        import torch
        torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        now = launch_counts()
        self.launches = {k: n - self._launches0.get(k, 0)
                         for k, n in now.items()}
        self.traced_steps = steps
        path = os.path.join(self.tmp, f"bench_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        del prof
        try:
            events = tracelib.load_trace(path)
        finally:
            os.remove(path)
        lo, hi, win = tracelib.marked_window(events)
        off = lo - self._t0_host * 1e6
        spans = [(a * 1e6 + off, b * 1e6 + off, name)
                 for name, a, b in self.spans.intervals]
        self.events = win
        summary = tracelib.busy_idle(win, lo, hi, spans)
        summary["device_ops"] = tracelib.device_ops(win)
        summary["shortfall"] = tracelib.kernel_shortfall(win, self.launches,
                                                         WRAPPERS)
        self.trace_summary = summary
        if summary["shortfall"]:
            print(f"bench: the trace lost hand-written kernels' events "
                  f"(launched, seen): {summary['shortfall']}",
                  file=sys.stderr)

    @property
    def trace_ok(self) -> bool:
        """A traced part whose device events are whole."""
        return self.events is not None and not self.trace_summary.get(
            "shortfall")


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(bench: speclib.Benchmark, cell: str, seed: int, seconds: float,
             traced: bool, device, t_start: float) -> Run:
    """Set up, measure and judge one run; return its :class:`Run`."""
    run = Run(bench, cell, seed, seconds, traced, device, t_start)
    drv = bench.driver(run.traffic["driver"])
    drv.setup(run)
    if getattr(device, "type", "cpu") == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        run.begin_trace()
        run.mark("profiler_start")
    run.setup_s = time.perf_counter() - t_start
    t = [run.setup_s]
    drv.window(run)
    t.append(time.perf_counter() - t_start)
    run.end_trace(run.attempted)
    run.memory_peak = 0
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(device))
    t.append(time.perf_counter() - t_start)
    drv.judge(run)
    t.append(time.perf_counter() - t_start)
    steps, last = [], t_start
    for name, at in run.marks:
        steps.append(f"{name} {at - last:.2f}")
        last = at
    print(f"bench: set-up steps (s): {', '.join(steps)}; seconds from the "
          f"start to the end of set-up, window, trace, judge: "
          f"{[round(x, 2) for x in t]}", file=sys.stderr)
    return run


def result_line(run: Run) -> dict:
    """The result's JSON object, the compared numbers last."""
    bench, name = run.bench, run.cell["name"]
    metrics = {}
    if run.traced:
        for m in bench.per_layer(name):
            v = bench.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in bench.end_to_end(name):
            v = run.setup_s if m["name"] == "setup_s" \
                else run.e2e.get(m["name"])
            if not _finite(v):
                raise RuntimeError(f"{name}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if getattr(run.device, "type", "") == "cuda"
           else "cpu",
           "kind": _device_name(run.device),
           "count": int(run.cell.get("chips", 1)),
           "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if run.traced and run.events is not None:
        s = run.trace_summary
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def _device_name(device) -> str:
    if getattr(device, "type", "") == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return "cpu"


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once "
                                 "and print its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: str, t_start: float) -> int:
    """The command line: exits non-zero, with no result, when the card is
    missing, the program cannot be imported, or a forbidden package was
    loaded."""
    args = parse_args(argv)
    bench = speclib.Benchmark(root)
    cell = bench.cell(args.workload)
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    line = result_line(run)
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

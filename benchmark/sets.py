"""Run one cell several times, one process a run as a check does, and
print each run's numbers and each metric's spread: the tool behind the
bounds (two sets of runs with the same seeds; a spread is the distance
between the quartiles over the median).

    python3 benchmark/sets.py --workload <name> --seeds 1,2,3 \
        --seconds 20 [--trace 1] [--sets 2] [--out runs.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> float:
    """(q3 - q1) / median, the quartiles as ``statistics.quantiles``
    gives them."""
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    rec = {"workload": workload, "seed": seed, "seconds": seconds,
           "trace": trace, "rc": p.returncode, "wall_s": wall}
    lines = p.stdout.strip().splitlines()
    try:
        rec["result"] = json.loads(lines[-1])
    except (IndexError, ValueError):
        rec["result"] = None
    rec["stderr_tail"] = p.stderr[-3000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    recs = []
    for k in range(a.sets):
        for s in seeds:
            r = one(a.workload, s, a.seconds, a.trace)
            r["set"] = k
            recs.append(r)
            res = r["result"] or {}
            m = {n: v["value"] for n, v in res.get("metrics", {}).items()}
            c = {n: v["value"] for n, v in res.get("checks", {}).items()}
            print(json.dumps({"set": k, "seed": s, "rc": r["rc"],
                              "wall_s": round(r["wall_s"], 1),
                              "correct": res.get("correct"),
                              "attempted": res.get("attempted"),
                              "failed": res.get("failed"),
                              "metrics": m, "checks": c,
                              "device": res.get("device"),
                              "breakdown": res.get("breakdown")}),
                  flush=True)
            if r["rc"] != 0 or not res:
                print(r["stderr_tail"], flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
    for k in range(a.sets):
        rs = [r["result"] for r in recs if r["set"] == k and r["result"]]
        names = sorted({n for r in rs for n in r["metrics"]})
        for n in names:
            v = [r["metrics"][n]["value"] for r in rs if n in r["metrics"]]
            print(f"set {k} {n}: median {statistics.median(v)!r} spread "
                  f"{spread(v):.5f} over {len(v)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

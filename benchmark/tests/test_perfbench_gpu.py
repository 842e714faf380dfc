"""On the card (``-m gpu``): each cell runs through the command line and
prints a correct result, and each cell's control, read at the cell's own
size, fails one of the cell's numbers."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

from benchmark.core import spec

CELLS = [w["name"] for w in spec.Benchmark(ROOT).doc["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                     "run.py"),
                        "--workload", cell, "--seed", str(2 ** 31 + 77),
                        "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    from benchmark import controls
    b = spec.Benchmark(ROOT)
    lim = b.limits(cell)
    r = controls.readings(b, cell, 2 ** 31 + 78, b.doc["run_seconds"], card)
    assert any(not v <= lim[k] for k, v in r["control"].items()
               if k in lim), r

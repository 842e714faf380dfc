"""The benchmark's own tests (CPU): ``python -m pytest benchmark/tests -q``.
Tests that need the card are marked ``gpu`` and skip inside a fixture
where there is none: ``python -m pytest benchmark/tests -q -m gpu`` on
the card.

``tiny_root`` copies the benchmark into a temporary checkout and adds
cells of tiny configurations (new files and entries only), the way a
later change adds a cell."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: limits of the tiny cells, set as a cell's are, from readings at this
#: size on SEEDS: the sound program's (LM 1.1e-4 / 3.2e-3 / 9.0e-3, CNN
#: 4.2e-2 / 3.0e-2 / 9.6e-2, rows 5.7e-3) and the fp8 control's (LM
#: grad_gap 8.5e-3 and more; rows 6.9e-2 and more; at batch 4 the CNN's
#: control reads no higher than the program, so only its faults are
#: held to it here) and the faults' (half a batch: LM loss 2.3e-3,
#: change 0.18; CNN 1.28 / 0.48 / 1.9; rows 7.2e-2)
TINY_LIMITS = {
    "tiny_gpt.tiny_lm": {"loss_gap": 0.001, "grad_gap": 0.0055,
                         "change_gap": 0.05},
    "tiny_alex.tiny_cnn": {"loss_gap": 0.1, "grad_gap": 0.15,
                           "change_gap": 0.3},
    "tiny_alex.tiny_pred": {"row_err": 0.02},
}
SEEDS = (7, 2 ** 31 + 12345)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the benchmark on the card); "
        "skipped elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the "
                    "H100")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _dump(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def make_tiny_root(tmp) -> str:
    """A checkout holding the benchmark and three tiny cells."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(bdir, "configs", "cerebras_gpt_1p3b.json")) as f:
        lm = json.load(f)
    lm["name"] = "tiny_gpt"
    lm["model"].update(n_embd=64, n_layer=2, n_head=4, n_inner=256,
                       n_positions=64, vocab_size=512)
    lm["builder"]["args"].update(vocab=512, seq=64, dim=64, nlayer=2,
                                 nhead=4)
    _dump(os.path.join(bdir, "configs", "tiny_gpt.json"), lm)
    with open(os.path.join(bdir, "configs", "alexnet.json")) as f:
        alex = json.load(f)
    alex["name"] = "tiny_alex"
    _dump(os.path.join(bdir, "configs", "tiny_alex.json"), alex)
    traffic = {}
    for new, old, upd in (
            ("tiny_lm", "train_shortdocs",
             {"rows": 4, "median_len": 40, "min_len": 4, "max_len": 60}),
            ("tiny_cnn", "train_b256", {"batch": 4, "ring": 4,
                                        "trace_steps": 2}),
            ("tiny_pred", "pred_b256", {"batch": 4, "ring": 3,
                                        "trace_steps": 2})):
        with open(os.path.join(bdir, "workloads", old + ".json")) as f:
            t = json.load(f)
        t.update(upd)
        traffic[new] = t
        _dump(os.path.join(bdir, "workloads", new + ".json"), t)
    bench = copy.deepcopy(bench)
    for name in ("tiny_gpt", "tiny_alex"):
        bench["configs"].append({
            "name": name, "source": "a tiny test configuration",
            "file": f"benchmark/configs/{name}.json", "reduced": [],
            "why": "tests"})
    for cell, lim in TINY_LIMITS.items():
        c, t = cell.split(".")
        bench["workloads"].append({"name": cell, "config": c, "traffic": t,
                                   "chips": 1, "why": "tests"})
        _dump(os.path.join(bdir, "limits", cell + ".json"), lim)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)

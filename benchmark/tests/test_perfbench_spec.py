"""BENCHMARK.json against the contract's shape, and every piece found by
its name; a cell, a configuration, a traffic mix and a per-layer metric
added as new files and entries alone."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT, make_tiny_root

from benchmark.core import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return spec.Benchmark(ROOT)


def test_top_level_keys_and_sizes():
    doc = _bench().doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(doc["paths"]) <= 16
    for p in doc["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.rstrip("/").endswith("_torch")
    assert 1 <= len(doc["command"]) <= 32
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(doc["run_seconds"], int) and \
        1 <= doc["run_seconds"] <= 51
    n = len(doc["workloads"])
    # a full check with 24 cells fits its time
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24 and 1 <= len(doc["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in doc["workloads"]) <= max(1, n // 4)


def test_entries_follow_the_contract():
    b = _bench()
    doc = b.doc
    names = [c["name"] for c in doc["configs"]] + \
        [w["name"] for w in doc["workloads"]] + \
        [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in doc["workloads"])
    files = [c["file"] for c in doc["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in doc["end_to_end"]}
    for w in doc["workloads"]:
        cell = w["name"]
        got = {m["name"] for m in b.end_to_end(cell)}
        assert "setup_s" in got and len(got) >= 2
        layer = b.per_layer(cell)
        assert layer
        for m in layer:
            assert m["moves"] in got and m["moves"] in e2e


def test_every_piece_is_found_by_name():
    b = _bench()
    for w in b.doc["workloads"]:
        cfg = b.config(w["config"])
        t = b.traffic(w["traffic"])
        drv = b.driver(t["driver"])
        for fn in ("setup", "window", "judge"):
            assert callable(getattr(drv, fn))
        ref = b.reference(cfg["family"])
        assert callable(ref.leaf_specs)
        assert b.limits(w["name"])
    for m in b.doc["per_layer"]:
        assert callable(b.reader(m["name"]).read)


def test_configurations_keep_their_widths():
    b = _bench()
    lm = b.config("cerebras_gpt_1p3b")["model"]
    assert (lm["n_embd"], lm["n_layer"], lm["n_head"], lm["n_inner"],
            lm["n_positions"], lm["vocab_size"]) == \
        (2048, 24, 16, 8192, 2048, 50257)
    for c in b.doc["configs"]:
        assert b.config(c["name"])["reduced"] == c["reduced"] == []


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    root = make_tiny_root(tmp_path)
    # a new per-layer metric: one file and one entry
    mdir = os.path.join(root, "benchmark", "metrics")
    with open(os.path.join(mdir, "steps_traced.tiny_lm.py"), "w") as f:
        f.write("def read(run):\n    return run.traced_steps or None\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        doc = json.load(f)
    doc["per_layer"].append({
        "name": "steps_traced.tiny_lm", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "model step",
        "moves": "setup_s", "workloads": ["tiny_gpt.tiny_lm"]})
    with open(path, "w") as f:
        json.dump(doc, f)
    b = spec.Benchmark(root)
    assert b.cell("tiny_gpt.tiny_lm")["traffic"] == "tiny_lm"
    assert b.config("tiny_gpt")["model"]["n_embd"] == 64
    assert "steps_traced.tiny_lm" in \
        [m["name"] for m in b.per_layer("tiny_gpt.tiny_lm")]
    assert "steps_traced.tiny_lm" not in \
        [m["name"] for m in b.per_layer("alexnet.train_b256")]
    # the repository's own files are untouched by it
    assert "tiny_gpt.tiny_lm" not in \
        [w["name"] for w in _bench().doc["workloads"]]


def test_result_line_keys(tiny_root):
    import time

    import torch
    b = spec.Benchmark(tiny_root)
    run = harness.run_cell(b, "tiny_gpt.tiny_lm", 7, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    line = harness.result_line(run)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert line["metrics"]["setup_s"]["unit"] == "s"
    assert line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "alexnet.pred_b256", "--seed", "1",
                       "--seconds", "1"], ROOT, 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


@pytest.mark.parametrize("mods,bad", [
    (["cxxnet_tpu_torch", "cxxnet_tpu_torch.ops"], []),
    (["jax.numpy"], ["jax"]), (["cxxnet_tpu.nnet"], ["cxxnet_tpu"]),
    (["flax"], ["flax"]), (["jaxlib.xla_client"], ["jaxlib"])])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, mods, bad):
    import sys
    for m in mods:
        monkeypatch.setitem(sys.modules, m, object())
    assert [x for x in harness.forbidden_modules() if x in bad] == bad

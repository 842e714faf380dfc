"""The benchmark as data: ``BENCHMARK.json`` at the root of a checkout,
and beside it, under the benchmark's folder, one file for each piece,
found by the name ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` its entry names (sizes, the program's
  keys, the plain reference's family);
* a traffic mix: ``workloads/<traffic>.json`` (its parameters and the
  driver that runs it);
* a kind of timed entry: ``drivers/<driver>.py``;
* a plain reference: ``reference/<family>.py``;
* a per-layer metric: ``metrics/<metric name>.py`` with ``read(ctx)``;
* a cell's correctness limits: ``limits/<cell name>.json``.

A later cell, configuration or metric is new files and new entries; no
file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

FOLDER = "benchmark"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` of the checkout ``root`` and its pieces."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, FOLDER)
        self.doc = load_json(os.path.join(self.root, "BENCHMARK.json"))
        self._modules: Dict[str, ModuleType] = {}

    # ---------------------------------------------------------- entries
    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def config_entry(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.doc["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a list whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    # ------------------------------------------------------------ files
    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.root,
                                      self.config_entry(name)["file"]))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "workloads", name + ".json"))

    def limits(self, cell: str) -> Dict[str, float]:
        return load_json(os.path.join(self.dir, "limits", cell + ".json"))

    def driver(self, name: str) -> ModuleType:
        return self._module("drivers", name)

    def reference(self, family: str) -> ModuleType:
        return self._module("reference", family)

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric)

    def _module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` of the benchmark folder, loaded from its
        file (a metric's name holds dots, so not by import), once."""
        path = os.path.join(self.dir, kind, name + ".py")
        mod = self._modules.get(path)
        if mod is None:
            sp = importlib.util.spec_from_file_location(
                f"bench_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(sp)
            sp.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

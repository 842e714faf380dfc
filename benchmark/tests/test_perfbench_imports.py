"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level name), or reads the JAX package's benchmark files; the
plain references import nothing of the program."""

from __future__ import annotations

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "cxxnet_tpu"}


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_by_whole_top_level_name(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", ["gpt2.py", "alexnet.py"])
def test_references_import_nothing_of_the_program(name):
    path = os.path.join(BENCH, "reference", name)
    assert set(_imports(path)) <= {"__future__", "math", "typing", "numpy",
                                   "torch"}


def test_nothing_reads_the_jax_packages_benchmark_files():
    for path in _modules():
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            text = f.read()
        for word in ("bench.py", "BENCH_", "BASELINE", "MULTICHIP_"):
            assert word not in text, (path, word)

"""The check that decides ``correct`` fails what it has to: a run driven
with the timed path broken underneath (the harness's look for a card
skipped) comes out not correct, once for each fault a cell can have, and
the control (the reference in fp8 in the program's place) fails a
number of the cell."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import SEEDS, TINY_LIMITS

from benchmark import controls
from benchmark.core import harness, spec
from cxxnet_tpu_torch.nnet.trainer import NetTrainer


def _run(root, cell, seed=SEEDS[0]):
    b = spec.Benchmark(root)
    return harness.run_cell(b, cell, seed, 0.5, False, torch.device("cpu"),
                            time.perf_counter())


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(NetTrainer, "apply_update",
                        lambda self, grads, epoch: None)


def _half_batch(monkeypatch):
    orig = NetTrainer._batch_tensors

    def half(self, sb):
        inputs, info = orig(self, sb)
        n = sb.data.shape[0]
        mask = torch.ones(n, device=sb.data.device)
        mask[n // 2:] = 0
        info.mask = mask
        self.loss_scale = 1.0 / (n // 2)
        return inputs, info
    monkeypatch.setattr(NetTrainer, "_batch_tensors", half)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged,
                "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", ["tiny_gpt.tiny_lm", "tiny_alex.tiny_cnn"])
def test_a_training_fault_is_not_correct(tiny_root, monkeypatch, cell,
                                         fault):
    TRAIN_FAULTS[fault](monkeypatch)
    run = _run(tiny_root, cell)
    assert not run.correct, run.checks


def _rows_fault(monkeypatch, alter):
    orig = NetTrainer.predict_raw

    def faulty(self, batch):
        rows = orig(self, batch).copy()
        alter(rows)
        return rows
    monkeypatch.setattr(NetTrainer, "predict_raw", faulty)


def _copy_half(rows):
    n = rows.shape[0]
    rows[n // 2:] = rows[:n - n // 2]


def _alter_one(rows):
    rows[rows.shape[0] // 3] = np.roll(rows[rows.shape[0] // 3], 1)


@pytest.mark.parametrize("alter", [_copy_half, _alter_one],
                         ids=["half_batch", "answer_altered"])
def test_a_prediction_fault_is_not_correct(tiny_root, monkeypatch, alter):
    _rows_fault(monkeypatch, alter)
    run = _run(tiny_root, "tiny_alex.tiny_pred")
    assert not run.correct, run.checks
    assert run.failed > 0


def _fails(readings: dict, limits: dict) -> bool:
    """True when a number the limits name reads above its limit."""
    return any(not v <= limits[k] for k, v in readings.items()
               if k in limits)


@pytest.mark.parametrize("cell", ["tiny_gpt.tiny_lm", "tiny_alex.tiny_pred"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(tiny_root, cell, seed):
    r = controls.readings(spec.Benchmark(tiny_root), cell, seed, 0.5,
                          torch.device("cpu"))
    assert _fails(r["control"], TINY_LIMITS[cell]), r
    assert _fails(r["half_batch"], TINY_LIMITS[cell]), r


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, dtype=torch.float64)
    e8 = (controls.fp8(x) - x).abs().max() / x.abs().max()
    e16 = (x.to(torch.bfloat16).double() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16
    y = torch.randn(8, requires_grad=True)
    controls.fp8(y).sum().backward()
    assert torch.equal(y.grad, torch.ones(8))

"""The plain references against themselves on tiny configurations, and
the sound program (its plain CPU path) against them."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, SEEDS

from benchmark.core import corpus, harness, spec, weights as W


def _tiny_lm():
    b = spec.Benchmark(ROOT)
    cfg = json.loads(json.dumps(b.config("cerebras_gpt_1p3b")))
    cfg["model"].update(n_embd=32, n_layer=2, n_head=2, n_inner=64,
                        n_positions=16, vocab_size=40)
    return b.reference("gpt2"), cfg


def test_pack_marks_boundaries_segments_and_positions():
    ref, _ = _tiny_lm()
    docs = [np.arange(5), np.arange(10, 13), np.arange(20, 30)]
    (b,) = ref.pack(docs, rows=2, seq=4, batches=1)
    assert b["tok"].tolist() == [[0, 1, 2, 3], [4, 10, 11, 12]]
    # a document runs on across a row: its last target is the next row's
    assert b["tgt"].tolist() == [[1, 2, 3, 4], [-1, 11, 12, -1]]
    assert b["seg"].tolist() == [[1, 1, 1, 1], [1, 2, 2, 2]]
    assert b["pos"].tolist() == [[0, 1, 2, 3], [3, 0, 1, 2]]


def test_positions_past_the_table_stay_at_its_last_row():
    ref, _ = _tiny_lm()
    (b,) = ref.pack([np.arange(13)], rows=3, seq=4, batches=1)
    assert b["pos"].tolist() == [[0, 1, 2, 3], [3, 3, 3, 3], [3, 3, 3, 3]]


def test_lm_training_is_the_same_in_any_block_of_rows():
    ref, cfg = _tiny_lm()
    w = W.make(ref.leaf_specs(cfg), 3, torch.device("cpu"), torch.float32)
    docs = corpus.documents({"length_seed": 1, "median_len": 6,
                             "sigma_len": 0.5, "min_len": 2, "max_len": 20},
                            3, 4 * 16 * 3 + 1, 40)
    batches = ref.pack(docs, 4, 16, 2)
    opt = {"d1": 0.1, "d2": 0.001, "eta": 1e-3, "eps": 1e-8}
    a = ref.train(w, batches, cfg, opt, block=1)
    b = ref.train(w, batches, cfg, opt, block=4)
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-5)
    for k in a["grad_norms"]:
        assert a["grad_norms"][k] == pytest.approx(b["grad_norms"][k],
                                                   rel=1e-4, abs=1e-9)
    assert a["losses"][-1] < a["losses"][0]
    # the key's bias gets no gradient under softmax
    assert a["grad_norms"]["l0_att/bqkv.k"] < 1e-6 * a["grad_norms"][
        "l0_att/bqkv.q"]


def test_lm_loss_is_the_mean_of_each_rows_mean():
    ref, cfg = _tiny_lm()
    w = W.make(ref.leaf_specs(cfg), 4, torch.device("cpu"), torch.float32)
    (b,) = ref.pack([np.arange(40) % 40], 2, 16, 1)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    per_row = ref.row_losses(w, t, cfg)
    one = [ref.row_losses(w, {k: v[[r]] for k, v in t.items()}, cfg)
           for r in range(2)]
    assert per_row.tolist() == pytest.approx([float(x) for x in one],
                                             rel=1e-5)


def test_alexnet_lrn_matches_its_definition():
    b = spec.Benchmark(ROOT)
    ref = b.reference("alexnet")
    x = torch.randn(2, 7, 3, 3, dtype=torch.float64)
    y = ref._lrn(x, 5, 0.001, 0.75, 1.0)
    want = torch.empty_like(x)
    for c in range(7):
        lo, hi = max(0, c - 2), min(6, c + 2)
        s = (x[:, lo:hi + 1] ** 2).sum(1)
        want[:, c] = x[:, c] * (1.0 + 0.001 / 5 * s) ** -0.75
    assert torch.allclose(y, want)


def test_alexnet_masks_follow_the_seeded_generator():
    b = spec.Benchmark(ROOT)
    ref = b.reference("alexnet")
    cfg = b.config("alexnet")
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    m1 = ref.dropout_masks(g1, 3, cfg, "cpu")
    u = torch.rand((3, 1, 1, 4096), generator=g2)
    assert torch.equal(m1[0], (u < 0.5).float().reshape(3, 4096) * 2.0)


@pytest.mark.parametrize("cell", ["tiny_gpt.tiny_lm", "tiny_alex.tiny_cnn",
                                  "tiny_alex.tiny_pred"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_sound_program_is_correct(tiny_root, cell, seed):
    b = spec.Benchmark(tiny_root)
    run = harness.run_cell(b, cell, seed, 0.5, False, torch.device("cpu"),
                           time.perf_counter())
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.failed == 0

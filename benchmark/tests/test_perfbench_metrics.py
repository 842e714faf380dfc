"""The frozen arithmetic, the trace reading and every metric's reader on
synthetic spans, traces and counters."""

from __future__ import annotations

import statistics
import types

import numpy as np
import pytest

from conftest import ROOT

from benchmark import sets
from benchmark.core import arith, readers, spec, trace
from benchmark.core.spans import Spans


# ------------------------------------------------------------- arith
def test_bound_picks_the_larger_time():
    assert arith.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert arith.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert arith.bound_s(989e12, 3.35e12 * 2) == pytest.approx(2.0)


def test_live_pairs_counts_triangles_and_padding_diagonals():
    seg = np.array([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 1, 1]])
    assert list(arith.live_pairs_rows(seg)) == [6 + 3 + 1, 21]
    assert arith.live_pairs(seg, heads=16) == 31 * 16


def test_attention_cost():
    c = arith.attention_cost(pairs=10, tokens=4, heads=2, head_dim=8)
    assert c["fwd"]["flops"] == 4 * 10 * 2 * 8
    assert c["bwd"]["flops"] == 8 * 10 * 2 * 8
    col = 4 * 2 * 8 * 2
    assert c["fwd"]["bytes"] == 4 * col + 4 * 2 * 4
    assert c["bwd"]["bytes"] == 8 * col + 4 * 2 * 4


def test_alexnet_geometry_and_flops():
    b = spec.Benchmark(ROOT)
    ref = b.reference("alexnet")
    cfg = b.config("alexnet")
    g = ref.geometry(cfg, 1)
    assert [c["oh"] for c in g["convs"]] == [55, 27, 13, 13, 13]
    assert [p["out"] for p in g["pools"]] == [96 * 27 * 27, 256 * 13 * 13,
                                              256 * 6 * 6]
    assert [x["numel"] for x in g["lrns"]] == [96 * 27 * 27, 256 * 13 * 13]
    fwd = ref.forward_flops(cfg, 1)
    # AlexNet (grouped): 0.72 G multiply-adds a forward, 2 flops each
    assert 1.40e9 < fwd < 1.50e9
    c1 = 2.0 * 96 * 55 * 55 * 3 * 11 * 11
    assert ref.train_flops(cfg, 1) == pytest.approx(3 * fwd - c1)


def test_pool_and_conv_sizes():
    assert arith.pool_out(55, 3, 2) == 27
    assert arith.pool_out(56, 3, 2) == 28  # a clipped tail window
    assert arith.conv_out(227, 11, 4, 0) == 55


def test_percentile_and_spread():
    v = [1.0, 2.0, 3.0, 4.0, 100.0]
    assert arith.percentile(v, 50) == 3.0
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert sets.spread(v) == pytest.approx((q3 - q1) / med)


# ------------------------------------------------------------- trace
def _k(name, ts, dur, corr=None):
    e = {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_interval_arithmetic():
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.clip([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(P)",
     "flash_fwd_wgmma_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, F>(int, F)",
     "vectorized_elementwise_kernel"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT",
     "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT"),
    ("void spin_kernel(long)", "spin_kernel"),
    ("_ZN17cutlass__5x_cudnn6KernelI" * 100,
     "_ZN17cutlass__5x_cudnn6KernelI" * 100)])
def test_kernel_base(name, base):
    assert trace.kernel_base(name) == base


def test_marked_window_busy_idle_and_gaps():
    ev = [_k("spin_kernel", 100, 1), _k("a", 110, 10), _k("a", 130, 10),
          _k("b", 150, 20), _k("spin_kernel", 200, 1), _k("a", 300, 5)]
    lo, hi, win = trace.marked_window(ev)
    assert (lo, hi) == (100, 200)
    assert [e["name"] for e in win] == ["a", "a", "b"]
    spans = [(100, 125, "update"), (125, 160, "input_wait")]
    s = trace.busy_idle(win, lo, hi, spans)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["idle_gaps"][0] == ["between_spans", pytest.approx(30e-6)]
    assert ["update", pytest.approx(10e-6)] in s["idle_gaps"]
    assert ["input_wait", pytest.approx(10e-6)] in s["idle_gaps"]
    ops = dict(trace.device_ops(win))
    assert ops == {"a": pytest.approx(20e-6), "b": pytest.approx(20e-6)}


def test_marked_window_needs_two_markers():
    with pytest.raises(RuntimeError):
        trace.marked_window([_k("spin_kernel", 1, 1), _k("a", 2, 1)])


def test_shortfall_against_launch_counters():
    wrappers = (("m", "w1", (("k1",), ("k2", "k2b"))), ("m", "w2",
                                                         (("k3",),)))
    ev = [_k("k1", 0, 1), _k("k1", 2, 1), _k("k2b", 3, 1), _k("k2", 4, 1),
          _k("k3", 5, 1)]
    assert trace.kernel_shortfall(ev, {"w1": 2, "w2": 1}, wrappers) == {}
    short = trace.kernel_shortfall(ev, {"w1": 2, "w2": 2}, wrappers)
    assert short == {"k3": (2, 1)}
    assert trace.kernel_names(wrappers, ["w1"]) == {"k1", "k2", "k2b"}
    assert trace.kernel_us(ev, {"k1", "k3"}) == 3


def test_device_time_inside_host_ranges():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "train_update",
           "ts": 10, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 12, "dur": 1, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 30, "dur": 1, "args": {"correlation": 8}},
          _k("adam", 40, 5, corr=7), _k("other", 50, 9, corr=8)]
    assert trace.in_ranges_us(ev, "train_update") == 5


def test_spans_time_and_intervals():
    sp = Spans(traced=True)
    for _ in range(3):
        with sp.span("update"):
            pass
    assert sp.calls["update"] == 3 and len(sp.intervals) == 3
    assert Spans(traced=False).intervals == []


# ----------------------------------------------------------- readers
def _run(cell, **kw):
    b = spec.Benchmark(ROOT)
    w = b.cell(cell)
    run = types.SimpleNamespace(
        bench=b, cell=w, config=b.config(w["config"]),
        traffic=b.traffic(w["traffic"]),
        reference=b.reference(b.config(w["config"])["family"]),
        spans=Spans(), traced_steps=2, launches={}, events=[],
        trace_summary={"busy_s": 0.9, "window_s": 1.0, "shortfall": {}},
        info={}, memory_peak=0, arith=arith)
    run.trace_ok = True
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_idle_mfu_and_memory_readers():
    b = spec.Benchmark(ROOT)
    run = _run("alexnet.train_b256")
    assert b.reader("device_idle.train_cnn").read(run) == pytest.approx(10)
    flops = run.reference.train_flops(run.config, 256) * 2
    assert b.reader("mfu.train_cnn").read(run) == pytest.approx(
        100 * flops / 1.0 / arith.PEAK_BF16)
    run.trace_ok = False
    assert b.reader("device_idle.train_cnn").read(run) is None
    lm = _run("cerebras_gpt_1p3b.train_shortdocs", memory_peak=3 * 2 ** 30)
    assert b.reader("peak_mem_gib.train_lm").read(lm) == pytest.approx(3)


def test_input_wait_reader():
    b = spec.Benchmark(ROOT)
    run = _run("alexnet.pred_b256")
    run.spans.seconds["input_wait"] = 0.004
    run.spans.calls["input_wait"] = 2
    assert b.reader("input_wait_ms.pred").read(run) == pytest.approx(2.0)


def _lm_run(durations_us):
    seq = 2048
    lab = np.zeros((8, 3 * seq), np.float32)
    lab[:, seq:2 * seq] = 1 + np.arange(seq) // 512     # four docs of 512
    ev = []
    for name, us in durations_us:
        ev.append(_k(name, 0, us))
    run = _lm_run_base(lab, ev)
    return run


def _lm_run_base(lab, ev):
    run = _run("cerebras_gpt_1p3b.train_shortdocs", events=ev)
    run.info = {"seq": 2048, "labels": [lab, lab]}
    run.launches = {"flash_attention_seg_fwd": 48,
                    "flash_attention_seg_bwd": 48}
    return run


def test_attention_roofline_reader():
    b = spec.Benchmark(ROOT)
    run = _lm_run([("flash_fwd_wgmma_kernel", 1000.0),
                   ("flash_bwd_dq_wgmma_kernel", 1000.0),
                   ("flash_bwd_dkv_wgmma_kernel", 1000.0),
                   ("nvjet_other", 5000.0)])
    g = run.reference.dims(run.config)
    pairs = 8 * 4 * (512 * 513 // 2)
    c = arith.attention_cost(pairs, 8 * 2048, g["H"], 128)
    want = 2 * g["L"] * arith.sum_bound_s((c["fwd"], c["bwd"]))
    got = b.reader("attn_roofline.train_lm").read(run)
    assert got == pytest.approx(100 * want / 3000e-6)
    run.launches["flash_attention_seg_fwd"] = 47
    assert b.reader("attn_roofline.train_lm").read(run) is None


def test_lm_mfu_counts_matmuls_and_live_pairs():
    b = spec.Benchmark(ROOT)
    run = _lm_run([])
    g = run.reference.dims(run.config)
    pairs = 8 * 4 * (512 * 513 // 2)
    per_step = 6.0 * run.reference.matmul_params(run.config) * 8 * 2048 \
        + 12 * 128 * g["H"] * g["L"] * pairs
    assert b.reader("mfu.train_lm").read(run) == pytest.approx(
        100 * 2 * per_step / arith.PEAK_BF16)


def test_cnn_kernel_roofline_reader():
    b = spec.Benchmark(ROOT)
    ev = [_k("lrn_fwd_kernel", 0, 100.0), _k("max_pool_fwd_cells_kernel",
                                             0, 100.0)]
    run = _run("alexnet.pred_b256", events=ev,
               launches={"lrn_fwd": 4, "max_pool_fwd": 6})
    want = readers.cnn_kernel_bound_s(run, False)
    assert b.reader("cnn_kernel_roofline.pred").read(run) == pytest.approx(
        100 * want / 200e-6)
    run.launches = {"lrn_fwd": 4, "max_pool_fwd": 5}
    assert b.reader("cnn_kernel_roofline.pred").read(run) is None


def test_update_ms_reader():
    b = spec.Benchmark(ROOT)
    ev = [{"ph": "X", "cat": "user_annotation", "name": "train_update",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 1, "dur": 1, "args": {"correlation": 1}},
          _k("fused_adam_kernel", 200, 3000, corr=1)]
    run = _run("cerebras_gpt_1p3b.train_shortdocs", events=ev)
    assert b.reader("update_ms.train_lm").read(run) == pytest.approx(1.5)

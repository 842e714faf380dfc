"""The port's host span tracing against the JAX package, on the CPU
(doc/monitor.md ``trace_sample``, the ``span`` record).

Per path the two packages run the same conf and weights at
``trace_sample = 1``, and the spans' stage names and nesting (each
span's innermost enclosing span on its thread track) must be equal;
timings are not compared.  The paths: the micro-batched serve
(``ServeModel``: warmup, queue_wait / coalesce / dispatch with pad /
device / unpad / respond / request), generation with a draft and
chunked prefill (``GenModel``: decode_warmup, prefill_chunk, draft,
verify, sample, request), and a train run's checkpoint writer
(ckpt_blocked / ckpt_shard / ckpt_manifest / ckpt_prune) and device
prefetcher (prefetch_stage / prefetch_wait).  At ``trace_sample = 0``
the port writes no span record; the tracer itself is exercised as the
JAX package's tests/test_spans.py exercises its own; the repo's
``tools/spans2trace.py`` reads a port sink.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu_torch.monitor import spans as tspans  # noqa: E402
from cxxnet_tpu_torch.monitor.metrics import Metrics  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import (NetTrainer,  # noqa: E402
                                           params_from_jax)
from cxxnet_tpu_torch.utils.config import parse_config_string  # noqa: E402
from test_torch_monitor import _golden_conf  # noqa: E402
from test_torch_monitor import golden  # noqa: E402,F401

#: microseconds a child's truncated stamps may stick out of its parent's
NEST_SLACK_US = 2


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _spans(path):
    return [r for r in _records(path) if r["kind"] == "span"]


def _shape(spans):
    """``{(stage, enclosing stage or None)}``: each span's innermost
    enclosing span on the same thread track."""
    by_tid = {}
    for r in spans:
        by_tid.setdefault(r["tid"], []).append(r)
    out = set()
    for rs in by_tid.values():
        for r in rs:
            a, b = r["us"], r["us"] + r["dur_us"]
            parents = [p for p in rs if p is not r
                       and p["us"] - NEST_SLACK_US <= a
                       and b <= p["us"] + p["dur_us"] + NEST_SLACK_US
                       and p["dur_us"] >= r["dur_us"]
                       and p["span"] != r["span"]]
            parent = min(parents, key=lambda p: p["dur_us"], default=None)
            out.add((r["span"], None if parent is None else parent["span"]))
    return out


def _carry(net, batch):
    """(JAX trainer, port trainer) holding the same weights."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(net, batch, "cpu", extra=[("silent", "1"),
                                                  ("eval_train", "0")])
    tt = NetTrainer()
    for k, v in parse_config_string(net) + [
            ("batch_size", str(batch)), ("dev", "cpu"), ("silent", "1"),
            ("eval_train", "0")]:
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


def _traced(trainer, path):
    trainer.metrics.configure_sink(f"jsonl:{path}")
    trainer.metrics.configure_tracer(1)
    return trainer.metrics


def _clients(n, fn):
    ths = [threading.Thread(target=fn, args=(i,), daemon=True,
                            name=f"client-{i}") for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()


MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,12
"""


def test_microbatched_serve_spans_match_jax(tmp_path):
    """ServeModel at buckets 1 / 4 / 8 under 6 concurrent clients of 3
    single-row requests each."""
    from cxxnet_tpu.serve import ServeConfig as JCfg
    from cxxnet_tpu.serve.host import ServeModel as JModel
    from cxxnet_tpu_torch.serve import ServeConfig as TCfg
    from cxxnet_tpu_torch.serve.host import ServeModel as TModel
    jt, tt = _carry(MLP, 8)
    rows = np.random.RandomState(0).rand(18, 1, 1, 12).astype(np.float32)
    shapes = {}
    for pkg, tr, model, cfg in (("jax", jt, JModel, JCfg),
                                ("port", tt, TModel, TCfg)):
        sink = tmp_path / f"{pkg}.jsonl"
        metrics = _traced(tr, sink)
        sm = model(tr, cfg(shapes=(1, 4, 8), max_wait_ms=5.0),
                   metrics=metrics, name="m")
        sm.warmup()
        _clients(6, lambda i: [sm.predict(rows[3 * i + j:3 * i + j + 1])
                               for j in range(3)])
        sm.close()
        metrics.close()
        shapes[pkg] = _shape(_spans(sink))
        reqs = [r for r in _spans(sink) if r["span"] == "request"]
        assert len(reqs) == 18
    assert shapes["port"] == shapes["jax"]
    names = {s for s, _ in shapes["port"]}
    assert names == {"serve_warmup", "queue_wait", "coalesce", "dispatch",
                     "pad", "device", "unpad", "respond", "request"}
    assert ("pad", "dispatch") in shapes["port"]


def test_request_span_equals_latency_sample(tmp_path):
    """A ``request`` span lasts the request's ``serve_latency_sec``
    sample (the span is stamped from that sample)."""
    from cxxnet_tpu_torch.serve import ServeConfig
    from cxxnet_tpu_torch.serve.host import ServeModel
    from cxxnet_tpu_torch.monitor.spans import stage_decomposition
    _, tt = _carry(MLP, 8)
    sink = tmp_path / "m.jsonl"
    metrics = _traced(tt, sink)
    sm = ServeModel(tt, ServeConfig(shapes=(1, 8)), metrics=metrics)
    sm.warmup()
    x = np.zeros((1, 1, 1, 12), np.float32)
    _clients(4, lambda i: [sm.predict(x) for _ in range(5)])
    sm.close()
    metrics.close()
    lat = sorted(metrics.histograms["serve_latency_sec"]._samples)
    req = sorted(r["dur_us"] for r in _spans(sink) if r["span"] == "request")
    assert len(req) == len(lat) == 20
    np.testing.assert_allclose(np.array(req) / 1e6, lat, atol=2e-6)
    dec = stage_decomposition(_records(sink))
    assert dec["requests"] == 20
    top = sum(s["share"] for s in dec["stages"]
              if s["stage"] in ("queue_wait", "coalesce", "dispatch",
                                "respond"))
    assert 0.9 <= top <= 1.1


def _lm_nets():
    from cxxnet_tpu_torch.models import transformer
    return (transformer(vocab=64, seq=32, dim=32, nlayer=2, nhead=2),
            transformer(vocab=64, seq=32, dim=16, nlayer=1, nhead=2))


def test_speculative_chunked_generation_spans_match_jax(tmp_path):
    """GenModel with a small draft, spec_k = 3, decode_prefill_chunk = 8,
    2 slots, 4 concurrent prompts of 5-20 tokens, 6 new tokens each."""
    from cxxnet_tpu.serve import ServeConfig as JCfg
    from cxxnet_tpu.serve.host import GenModel as JModel
    from cxxnet_tpu_torch.serve import ServeConfig as TCfg
    from cxxnet_tpu_torch.serve.host import GenModel as TModel
    net, draft = _lm_nets()
    (jt, tt), (jd, td) = _carry(net, 2), _carry(draft, 2)
    rnd = np.random.RandomState(3)
    prompts = [rnd.randint(0, 64, n).astype(np.int32) for n in (5, 9, 17, 20)]
    shapes, outs = {}, {}
    for pkg, tr, dr, model, cfg in (("jax", jt, jd, JModel, JCfg),
                                    ("port", tt, td, TModel, TCfg)):
        sink = tmp_path / f"{pkg}.jsonl"
        metrics = _traced(tr, sink)
        gm = model(tr, cfg(gen=1, slots=2, max_seqlen=32, gen_tokens=6,
                           spec_k=3, prefill_chunk=8),
                   draft_trainer=dr, metrics=metrics, name="lm")
        gm.warmup()
        got = [None] * len(prompts)

        def client(i):
            got[i] = list(gm.generate(prompts[i]))
        _clients(len(prompts), client)
        gm.close()
        metrics.close()
        outs[pkg] = got
        shapes[pkg] = _shape(_spans(sink))
    assert outs["port"] == outs["jax"]
    assert shapes["port"] == shapes["jax"]
    assert {s for s, _ in shapes["port"]} == {
        "decode_warmup", "prefill_chunk", "draft", "verify", "sample",
        "request"}


def test_ckpt_writer_and_prefetch_spans_match_jax(golden, tmp_path):  # noqa: F811
    """A train run of the golden conf with an async snapshot each round
    and a depth-2 prefetcher, in both CLIs."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    shapes = {}
    for pkg, task in (("jax", JTask), ("port", TTask)):
        sink = tmp_path / f"{pkg}.jsonl"
        assert task().run([_golden_conf(golden, f"sp_{pkg}"),
                           f"metrics_sink=jsonl:{sink}", "trace_sample=1",
                           "ckpt_async=1", "save_model=1",
                           f"model_dir={tmp_path}/m_{pkg}",
                           "prefetch_device=2"]) == 0
        shapes[pkg] = _shape(_spans(sink))
    assert shapes["port"] == shapes["jax"]
    assert {s for s, _ in shapes["port"]} == {
        "ckpt_blocked", "ckpt_shard", "ckpt_manifest", "ckpt_prune",
        "prefetch_stage", "prefetch_wait"}


def test_trace_sample_zero_writes_no_span(golden, tmp_path):  # noqa: F811
    """trace_sample = 0 (the default) with a sink: a train run with the
    writer and the prefetcher, and a served model, write no span."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.serve import ServeConfig
    from cxxnet_tpu_torch.serve.host import ServeModel
    sink = tmp_path / "t.jsonl"
    assert LearnTask().run([_golden_conf(golden, "off"),
                            f"metrics_sink=jsonl:{sink}", "trace_sample=0",
                            "ckpt_async=1", "save_model=1",
                            f"model_dir={tmp_path}/m"]) == 0
    assert _records(sink) and not _spans(sink)
    _, tt = _carry(MLP, 8)
    tt.metrics.configure_sink(f"jsonl:{tmp_path}/s.jsonl")
    sm = ServeModel(tt, ServeConfig(shapes=(1, 8)))
    sm.warmup()
    _clients(3, lambda i: sm.predict(np.zeros((1, 1, 1, 12), np.float32)))
    sm.close()
    tt.metrics.close()
    assert not _spans(tmp_path / "s.jsonl")
    assert not tt.metrics.tracer.enabled


def test_tracer_contract(tmp_path):
    """The tracer's own rules, as the JAX package's tests hold its own:
    off (no sink, or sample 0) allocates nothing and emits nothing;
    every Nth request sampled; ids disjoint across threads; link hands
    riders to spans inside it."""
    m = Metrics()
    tr = m.tracer
    assert tr.span("x") is tspans._NULL_SPAN and tr.new_trace() is None
    m.configure_tracer(1)
    assert not tr.enabled     # no sink yet
    m.configure_sink(f"jsonl:{tmp_path}/t.jsonl")
    m.configure_tracer(3)
    assert [tr.new_trace() for _ in range(6)] == [1, None, None, 2, None,
                                                  None]
    m.configure_tracer(1)
    ids = []
    lock = threading.Lock()

    def grab(_):
        got = [tr.new_trace() for _ in range(50)]
        with lock:
            ids.extend(got)
    _clients(4, grab)
    assert len(set(ids)) == 200
    with tr.link([5, 6]):
        with tr.span("inner", trace_id=None):
            pass
    m.configure_tracer(0)
    with tr.span("dropped"):
        pass
    m.close()
    recs = _spans(tmp_path / "t.jsonl")
    assert [r["span"] for r in recs] == ["inner"]
    assert recs[0]["riders"] == [5, 6]


def test_spans2trace_reads_port_sink(tmp_path):
    """tools/spans2trace.py, unedited, exports a port serve sink as
    Chrome trace events."""
    from cxxnet_tpu_torch.serve import ServeConfig
    from cxxnet_tpu_torch.serve.host import ServeModel
    _, tt = _carry(MLP, 8)
    sink = tmp_path / "s.jsonl"
    metrics = _traced(tt, sink)
    sm = ServeModel(tt, ServeConfig(shapes=(1, 8)), metrics=metrics)
    sm.warmup()
    _clients(3, lambda i: sm.predict(np.zeros((1, 1, 1, 12), np.float32)))
    sm.close()
    metrics.close()
    out = tmp_path / "trace.json"
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "spans2trace.py"),
                        str(sink), "-o", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    evs = json.load(open(out))
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    assert {e.get("name") for e in evs} >= {"request", "dispatch", "device"}

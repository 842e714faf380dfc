"""The port's micro-batched predict serving (``task = serve`` without
``serve_gen``) against the JAX package, on the CPU.

The micro-batcher's thread protocol over fake runners (coalescing, the
timeout flush, the batch cap, multi-row requests, exception fan-out,
shutdown hygiene, depth and latency accounting); the pinned-shape
predict engine over a small MLP and a LeNet-style conv net built by the
JAX package and carried over (its f32 rows against the JAX engine's,
buckets, padding, oversize splits, the bf16 and int8 variants within
``SERVE_TOL`` of f32, bf16 within ``SERVE_TOL`` of the JAX variant and
int8 within ``F32_TOL`` of it, int8 quantization bitwise); the model
host's routing and ready lifecycle; loading a JAX-written snapshot; and ``example/MNIST/serve.conf`` through both CLIs
on synthetic MNIST.
"""

import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.serve.engine import PredictEngine as JEngine  # noqa: E402
from cxxnet_tpu_torch.monitor.metrics import Metrics  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import (NetTrainer,  # noqa: E402
                                           params_from_jax)
from cxxnet_tpu_torch.serve import (ServeConfig, parse_shapes,  # noqa: E402
                                    shapes_check)
from cxxnet_tpu_torch.serve.batcher import (MicroBatcher,  # noqa: E402
                                            ServeClosed)
from cxxnet_tpu_torch.serve.engine import (SERVE_TOL,  # noqa: E402
                                           PredictEngine,
                                           quantize_per_channel)
from cxxnet_tpu_torch.serve.host import (ModelHost, ServeModel,  # noqa: E402
                                         load_serve_model)
from cxxnet_tpu_torch.utils.config import parse_config_string  # noqa: E402

#: f32 predict rows, port against the JAX engine
F32_TOL = 1e-5

MLP_NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 24
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 5
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,16
eta = 0.1
"""

CONV_NET = """
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  stride = 2
  nchannel = 6
  random_type = xavier
  no_bias = 0
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc1
  nhidden = 12
layer[4->5] = sigmoid:se1
layer[5->6] = fullc:fc2
  nhidden = 5
layer[6->6] = softmax
netconfig=end
input_shape = 1,12,12
eta = 0.1
"""

NETS = {"mlp": MLP_NET, "conv": CONV_NET}


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("cxxnet-serve")]


# ------------------------------------------------------------ batcher units

def _echo_runner(calls):
    """Row-aligned doubling that records each dispatched batch size."""
    def run(x):
        calls.append(x.shape[0])
        time.sleep(0.01)
        return x * 2.0
    return run


def test_batcher_coalesces_concurrent_requests():
    calls = []
    b = MicroBatcher(_echo_runner(calls), max_batch=16, max_wait_ms=50.0)
    b.start()
    try:
        outs = [None] * 8

        def client(i):
            outs[i] = b.submit(np.full((1, 4), float(i), np.float32))

        ths = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        for i in range(8):
            np.testing.assert_array_equal(outs[i], np.full((1, 4), 2.0 * i))
        assert b.n_requests == 8 and b.rows_served == 8
        assert b.n_batches < 8, calls
        assert sum(calls) == 8
    finally:
        b.close()


def test_batcher_timeout_flushes_partial_batch():
    calls = []
    b = MicroBatcher(_echo_runner(calls), max_batch=64, max_wait_ms=5.0)
    b.start()
    try:
        t0 = time.perf_counter()
        out = b.submit(np.ones((1, 3), np.float32))
        took = time.perf_counter() - t0
        np.testing.assert_array_equal(out, 2 * np.ones((1, 3)))
        assert calls == [1]
        assert took < 2.0, f"timeout flush took {took:.3f}s"
    finally:
        b.close()


def test_batcher_respects_max_batch():
    calls = []
    b = MicroBatcher(_echo_runner(calls), max_batch=4, max_wait_ms=100.0)
    b.start()
    try:
        ths = [threading.Thread(
            target=lambda: b.submit(np.zeros((1, 2), np.float32)))
            for _ in range(12)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert max(calls) <= 4
        assert sum(calls) == 12
    finally:
        b.close()


def test_batcher_multirow_requests_split_correctly():
    calls = []
    b = MicroBatcher(_echo_runner(calls), max_batch=32, max_wait_ms=30.0)
    b.start()
    try:
        outs = {}

        def client(i, n):
            outs[i] = b.submit(np.full((n, 2), float(i), np.float32))

        ths = [threading.Thread(target=client, args=(i, n))
               for i, n in enumerate((1, 3, 2))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        for i, n in enumerate((1, 3, 2)):
            assert outs[i].shape == (n, 2)
            np.testing.assert_array_equal(outs[i], np.full((n, 2), 2.0 * i))
    finally:
        b.close()


def test_batcher_runner_exception_reaches_all_clients():
    def boom(x):
        time.sleep(0.005)
        raise RuntimeError("device on fire")

    b = MicroBatcher(boom, max_batch=4, max_wait_ms=5.0, queue_depth=64)
    b.start()
    errs = []

    def client():
        try:
            b.submit(np.zeros((1, 2), np.float32))
        except RuntimeError as e:
            errs.append(str(e))

    ths = [threading.Thread(target=client) for _ in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in ths), "a client hung"
    assert errs == ["device on fire"] * 6
    with pytest.raises(RuntimeError, match="device on fire"):
        b.submit(np.zeros((1, 2), np.float32))
    b.close()
    assert not _serve_threads()


def test_batcher_close_thread_hygiene():
    b = MicroBatcher(_echo_runner([]), max_batch=4, max_wait_ms=1.0,
                     name="hygiene")
    b.start()
    assert any(t.name == "cxxnet-serve-batcher-hygiene"
               for t in threading.enumerate())
    b.submit(np.zeros((1, 2), np.float32))
    b.close()
    assert not any(t.name == "cxxnet-serve-batcher-hygiene"
                   for t in threading.enumerate())
    with pytest.raises(ServeClosed):
        b.submit(np.zeros((1, 2), np.float32))
    b.close()  # idempotent


def test_batcher_stats_accounting():
    b = MicroBatcher(_echo_runner([]), max_batch=8, max_wait_ms=1.0)
    b.start()
    try:
        for _ in range(3):
            b.submit(np.zeros((2, 2), np.float32))
        s = b.stats()
        assert s["requests"] == 3 and s["rows"] == 6
        assert sum(int(k) * v for k, v in s["batch_hist"].items()) == 6
        assert s["mean_batch"] == 2.0 and s["queue_depth_max"] >= 0
    finally:
        b.close()


def test_batcher_depth_accounting_sees_bursts():
    """A burst that arrives while the dispatcher is inside the runner
    and drains into the next dispatch is seen by the arrival-side depth
    sample."""
    gate = threading.Event()
    entered = threading.Event()

    def runner(x):
        entered.set()
        gate.wait(5.0)
        return x

    b = MicroBatcher(runner, max_batch=32, max_wait_ms=1.0, queue_depth=64)
    b.start()
    outs = []

    def client():
        outs.append(b.submit(np.zeros((1, 2), np.float32)))

    ths = [threading.Thread(target=client)]
    ths[0].start()
    assert entered.wait(5.0)
    for k in range(5):
        th = threading.Thread(target=client)
        th.start()
        ths.append(th)
        deadline = time.perf_counter() + 5.0
        while b._q.qsize() < k + 1 and time.perf_counter() < deadline:
            time.sleep(0.001)
    deadline = time.perf_counter() + 5.0
    while b.depth_max < 5 and time.perf_counter() < deadline:
        time.sleep(0.001)
    depth_seen = b.depth_max
    gate.set()
    for th in ths:
        th.join(timeout=10.0)
    b.close()
    assert len(outs) == 6
    assert depth_seen >= 5, depth_seen
    s = b.stats()
    assert s["queue_depth_max"] >= 5
    assert 0 < s["queue_depth_mean"] <= s["queue_depth_max"]
    assert b.depth_samples >= b.n_requests + b.n_batches


def test_batcher_latency_histogram():
    reg = Metrics()
    b = MicroBatcher(_echo_runner([]), max_batch=4, max_wait_ms=1.0,
                     metrics=reg)
    b.start()
    try:
        for _ in range(4):
            b.submit(np.zeros((1, 2), np.float32))
    finally:
        b.close()
    s = reg.histograms["serve_latency_sec"].summary()
    assert s["count"] == 4
    assert 0 < s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    assert reg.histograms["serve_batch_rows"].count == 4
    assert "serve_queue_depth" in reg.gauges


# ----------------------------------------------------------- engine + model

def _carry(net, batch=8):
    """(JAX trainer, port trainer) holding the same weights."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(net, batch, "cpu", extra=[("silent", "1")])
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in (("batch_size", str(batch)), ("dev", "cpu"),
                 ("silent", "1")):
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


@pytest.fixture(scope="module")
def pairs():
    return {name: _carry(net) for name, net in NETS.items()}


@pytest.fixture(scope="module")
def mlp_engine(pairs):
    eng = PredictEngine(pairs["mlp"][1], shapes=(1, 4, 8), dtype="f32")
    eng.warmup()
    return eng


def _rows(net, n, seed=0):
    shape = (1, 1, 16) if net == "mlp" else (1, 12, 12)
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def _rel(got, ref):
    return float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref)))
                                               + 1e-6)


def test_quantize_per_channel_matches_jax_bitwise():
    from cxxnet_tpu.serve.engine import quantize_per_channel as jquant
    rng = np.random.RandomState(0)
    w = rng.randn(6, 9).astype(np.float32)
    w[2] = 0.0  # dead channel: scale 0, no division by zero
    wc = rng.randn(4, 2, 3, 3).astype(np.float32)
    for arr in (w, wc):
        q, s = quantize_per_channel(arr)
        jq, js = jquant(arr)
        assert q.dtype == jq.dtype == np.int8
        assert np.array_equal(q, jq) and np.array_equal(s, js)
        assert s.shape == (arr.shape[0],) + (1,) * (arr.ndim - 1)
        np.testing.assert_allclose(q * s, arr,
                                   atol=float(s.max()) / 2 + 1e-7)
    assert not quantize_per_channel(w)[0][2].any()


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_f32_predict_matches_jax_engine(pairs, net):
    """Rows of 1..20 (padding and an oversize split) through both f32
    engines: within F32_TOL, the same buckets and pad rows, and zero
    retraces."""
    jt, tt = pairs[net]
    je = JEngine(jt, shapes=(1, 4, 8), dtype="f32")
    je.warmup()
    te = PredictEngine(tt, shapes=(1, 4, 8), dtype="f32")
    te.warmup()
    for n in (1, 3, 4, 5, 8, 19):
        x = _rows(net, n, seed=n)
        got = te.predict(x)
        assert got.shape == (n, 5) and got.dtype == np.float32
        np.testing.assert_allclose(got, je.predict(x), atol=F32_TOL)
    assert te.stats()["bucket_hist"] == je.stats()["bucket_hist"]
    assert te.pad_rows == je.pad_rows and te.dispatches == je.dispatches
    assert te.retraces == 0 == je.retraces


def test_bucket_for_pads_and_unpads(mlp_engine):
    assert [mlp_engine.bucket_for(n) for n in (1, 2, 4, 5, 8, 99)] \
        == [1, 4, 4, 8, 8, 8]
    d0, p0 = mlp_engine.dispatches, mlp_engine.pad_rows
    out = mlp_engine.predict(_rows("mlp", 3))
    assert out.shape == (3, 5)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    assert (mlp_engine.dispatches - d0, mlp_engine.pad_rows - p0) == (1, 1)
    # oversize: 8 + 8 + a 3-row remainder padded to 4
    big = mlp_engine.predict(_rows("mlp", 19))
    assert big.shape == (19, 5)
    assert (mlp_engine.dispatches - d0, mlp_engine.pad_rows - p0) == (4, 2)
    np.testing.assert_allclose(big[:8], mlp_engine.predict(
        _rows("mlp", 19)[:8]), atol=1e-6)
    assert mlp_engine.retraces == 0


def test_engine_rejects_bad_input_and_dtype(mlp_engine, pairs):
    with pytest.raises(ValueError, match="predict"):
        mlp_engine.predict(np.zeros((2, 1, 1, 7), np.float32))
    with pytest.raises(ValueError, match="serve_dtype"):
        PredictEngine(pairs["mlp"][1], dtype="fp8")
    with pytest.raises(ValueError, match="serve_shapes"):
        PredictEngine(pairs["mlp"][1], shapes=(0, 4))


@pytest.mark.parametrize("net", ["mlp", "conv"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_variants_within_envelope(pairs, net, dtype):
    """The variant against the port's f32 (pairtest) within SERVE_TOL;
    against the JAX package's same variant within SERVE_TOL at bf16 and
    within F32_TOL at int8 (both quantize bitwise alike and dequantize
    ``q * scale`` in float32, so only float32 rounding may part them);
    it really transforms the weights; int8 keeps int8 weights and
    float32 scales."""
    jt, tt = pairs[net]
    te = PredictEngine(tt, shapes=(4,), dtype=dtype)
    te.warmup()
    je = JEngine(jt, shapes=(4,), dtype=dtype)
    je.warmup()
    x = _rows(net, 4, seed=7)
    err = te.pairtest(x)
    assert 0.0 < err <= SERVE_TOL[dtype], err
    if dtype == "bf16":
        assert _rel(te.predict(x), je.predict(x)) <= SERVE_TOL[dtype]
    else:
        np.testing.assert_allclose(te.predict(x), je.predict(x),
                                   atol=F32_TOL)
    if dtype == "int8":
        keys = te._quant_keys()
        assert keys and set(te._scales) == keys
        for k in keys:
            assert te._params[k]["wmat"].dtype == torch.int8
            assert te._scales[k]["wmat"].dtype == torch.float32
    fp = te.footprint()
    assert fp["weight_bytes"] > 0 and fp["opt_bytes"] == 0
    assert fp["buckets"] == 1 and te.retraces == 0


def test_serve_model_concurrent_parity(pairs):
    """Concurrent single-row clients through ServeModel: each answer is
    the engine's single-shot row, zero retraces, clean shutdown."""
    sm = ServeModel(pairs["mlp"][1], ServeConfig(shapes=(1, 4, 8),
                                                 max_wait_ms=5.0),
                    name="parity")
    sm.warmup()
    try:
        x = _rows("mlp", 16, seed=11)
        want = sm.engine.predict(x)
        got = [None] * 16

        def client(i):
            got[i] = sm.predict(x[i:i + 1])

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in ths)
        for i in range(16):
            np.testing.assert_allclose(got[i][0], want[i], atol=1e-6)
        assert sm.retraces == 0 and sm.batcher.n_requests == 16
    finally:
        sm.close()
    assert not _serve_threads()


def test_model_host_routes_and_marks_ready(pairs):
    t_a = pairs["mlp"][1]
    t_b = _carry(MLP_NET.replace("nhidden = 5", "nhidden = 3"))[1]
    host = ModelHost()
    try:
        assert not host.mark_ready()        # nothing hosted
        host.add("alpha", t_a, ServeConfig(shapes=(1, 4)), warmup=False)
        assert not host.mark_ready() and not host.ready   # not warmed
        host.model("alpha").warmup()
        host.add("beta", t_b, ServeConfig(shapes=(1, 4)))
        assert host.mark_ready() and host.ready
        assert host.names == ["alpha", "beta"]
        x = _rows("mlp", 2, seed=5)
        assert host.predict("alpha", x).shape == (2, 5)
        assert host.predict("beta", x).shape == (2, 3)
        np.testing.assert_array_equal(host.predict("alpha", x),
                                      host.model("alpha").engine.predict(x))
        with pytest.raises(KeyError, match="gamma"):
            host.predict("gamma", x)
        with pytest.raises(ValueError, match="already hosted"):
            host.add("alpha", t_a)
        assert host.retraces() == 0
        fp = host.footprint()
        assert set(fp["models"]) == {"alpha", "beta"}
        assert fp["total_bytes"] == sum(m["total_bytes"]
                                        for m in fp["models"].values())
        adm = host.start_admin(Metrics(), port=0)
        assert host.admin is adm and adm.port > 0
    finally:
        host.close()
    assert not host.ready and host.names == [] and host.admin is None
    assert not _serve_threads()


def test_load_serve_model_from_jax_snapshot(tmp_path):
    """A JAX-written .model: the net and weights come from the snapshot,
    the serve_* pairs configure the front; rows match the JAX engine's."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(CONV_NET, 8, "cpu", extra=[("silent", "1")])
    snap = str(tmp_path / "0001.model")
    jt.save_model(snap)
    sm = load_serve_model(
        [("dev", "cpu"), ("batch_size", "8"), ("model_in", snap),
         ("serve_shapes", "1,4"), ("serve_dtype", "f32"), ("silent", "1")],
        name="reloaded")
    try:
        assert sm.engine.shapes == (1, 4) and sm.name == "reloaded"
        x = _rows("conv", 4, seed=2)
        je = JEngine(jt, shapes=(1, 4), dtype="f32")
        np.testing.assert_allclose(sm.predict(x), je.predict(x),
                                   atol=F32_TOL)
    finally:
        sm.close()
    with pytest.raises(ValueError, match="model_in"):
        load_serve_model([("dev", "cpu"), ("batch_size", "8")])


def test_serve_config_matches_jax():
    from cxxnet_tpu.serve import ServeConfig as JConfig
    from cxxnet_tpu.serve import shapes_check as jcheck
    pairs = [("serve_shapes", "1,8"), ("serve_dtype", "bf16"),
             ("serve_max_wait_ms", "3.5"), ("serve_clients", "2"),
             ("serve_shapes", "2,16"), ("serve_calib", "3"),
             ("spec_k", "3"), ("decode_prefill_chunk", "16"),
             ("serve_draft_model", "d.model"), ("decode_kv_dtype", "bf16"),
             ("unrelated", "x")]
    got, want = ServeConfig.from_pairs(pairs), JConfig.from_pairs(pairs)
    for f in ("shapes", "max_batch", "max_wait_ms", "dtype", "clients",
              "calib", "queue_depth", "spec_k", "prefill_chunk",
              "draft_model", "kv_dtype"):
        assert getattr(got, f) == getattr(want, f), f
    assert ServeConfig().max_batch == 32 == JConfig().max_batch
    assert parse_shapes("1,8,32") == [1, 8, 32]
    for bad in ("8,1", "1,1,8", "0,8", "-1", "a,b", ""):
        assert shapes_check(bad) == jcheck(bad) is not None, bad
        with pytest.raises(ValueError, match="serve_shapes"):
            parse_shapes(bad)
    for key, val in (("serve_dtype", "fp8"), ("spec_k", "-1"),
                     ("decode_kv_dtype", "f16")):
        with pytest.raises(ValueError, match=key):
            ServeConfig.from_pairs([(key, val)])


# --------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """Synthetic MNIST and a MNIST_CONV snapshot trained two rounds by
    the JAX CLI."""
    import make_synth_mnist as synth
    from cxxnet_tpu.main import LearnTask as JTask
    tmp = tmp_path_factory.mktemp("serve_cli")
    data = tmp / "data"
    data.mkdir()
    for split, n, seed in (("train", 600, 0), ("t10k", 150, 1)):
        imgs, labels = synth.make_split(n, seed)
        synth.write_idx_images(str(data / f"{split}-images-idx3-ubyte.gz"),
                               imgs)
        synth.write_idx_labels(str(data / f"{split}-labels-idx1-ubyte.gz"),
                               labels)
    text = open(os.path.join(REPO, "example/MNIST/MNIST_CONV.conf")).read()
    conf = tmp / "train.conf"
    conf.write_text(text.replace("./data/", f"{data}/"))
    assert JTask().run([str(conf), "dev=cpu", "num_round=2", "max_round=2",
                        f"model_dir={tmp}/models", "save_model=2",
                        "silent=1"]) == 0
    return tmp, str(tmp / "models" / "0002.model")


def _mnist_conf(tmp, model, name, task="serve"):
    """example/MNIST/serve.conf pointed at this run's data, snapshot,
    output and metrics files."""
    text = open(os.path.join(REPO, "example/MNIST/serve.conf")).read()
    text = (text.replace("./data/", f"{tmp}/data/")
            .replace("model_in = models/0010.model", f"model_in = {model}")
            .replace("pred = serve_out.txt", f"pred = {tmp}/{name}_out.txt")
            .replace("metrics_sink = jsonl:serve_metrics.jsonl",
                     f"metrics_sink = jsonl:{tmp}/{name}.jsonl")
            .replace("task = serve", f"task = {task}"))
    conf = tmp / f"{name}.conf"
    conf.write_text(text)
    return str(conf)


def _records(path, kind):
    return [r for r in map(json.loads, open(path)) if r["kind"] == kind]


def test_cli_serve_conf_matches_pred_and_jax_cli(mnist):
    """example/MNIST/serve.conf at f32 through the port's CLI: its
    serve_out equals its own task = pred output and the JAX CLI's serve
    output, line for line; the latency and serve records count every
    request, and retraces stay 0."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    tmp, model = mnist
    outs = {}
    for name, task, kind in (("port", TTask, "serve"),
                             ("port_pred", TTask, "pred"),
                             ("jax", JTask, "serve")):
        t = task()
        assert t.run([_mnist_conf(tmp, model, name, kind),
                      "input_flat=0"]) == 0
        outs[name] = open(tmp / f"{name}_out.txt").read()
    assert outs["port"] == outs["port_pred"] == outs["jax"]
    assert len(outs["port"].splitlines()) == 150
    [lat] = _records(tmp / "port.jsonl", "latency")
    [srv] = _records(tmp / "port.jsonl", "serve")
    assert lat["op"] == "serve" and lat["count"] == 150
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert srv["retraces"] == 0 and srv["dtype"] == "f32"
    assert srv["requests"] == srv["rows"] == 150
    assert sum(int(k) * v for k, v in srv["batch_hist"].items()) == 150
    assert srv["queue_depth_max"] >= srv["queue_depth_mean"] >= 0
    assert srv["shapes"] == [1, 8, 32] and srv["clients"] == 4
    assert sum(srv["engine"]["bucket_hist"].values()) \
        == srv["engine"]["dispatches"] == srv["batches"]
    assert srv["footprint"]["weight_bytes"] > 0
    assert "quant_rel_err" not in srv
    assert not _serve_threads()


def test_cli_serve_int8_with_calibration(mnist):
    """serve_dtype = int8 with serve_calib = 2: the startup pairtest lands
    in the serve record within the int8 envelope, and the predictions
    still agree with f32's on nearly every row."""
    from cxxnet_tpu_torch.main import LearnTask
    tmp, model = mnist
    task = LearnTask()
    assert task.run([_mnist_conf(tmp, model, "int8"), "input_flat=0",
                     "serve_dtype=int8", "serve_calib=2"]) == 0
    [srv] = _records(tmp / "int8.jsonl", "serve")
    assert srv["dtype"] == "int8" and srv["retraces"] == 0
    assert 0 < srv["quant_rel_err"] <= SERVE_TOL["int8"]
    assert task.last_serve["quant_rel_err"] == srv["quant_rel_err"]
    assert LearnTask().run([_mnist_conf(tmp, model, "f32_pred", "pred"),
                            "input_flat=0"]) == 0
    out = np.loadtxt(tmp / "int8_out.txt")
    ref = np.loadtxt(tmp / "f32_pred_out.txt")
    assert out.shape == ref.shape == (150,)
    assert np.mean(out == ref) >= 0.95


def test_cli_serve_without_dev_cpu_raises_without_a_card(mnist):
    """The micro-batched path runs on the card unless dev = cpu: with the
    conf's dev line dropped (the default, gpu) and no card, it raises
    before serving anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cxxnet_tpu_torch.main import LearnTask
    tmp, model = mnist
    conf = _mnist_conf(tmp, model, "nodev")
    text = open(conf).read().replace("dev = cpu\n", "")
    open(conf, "w").write(text)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnTask().run([conf, "input_flat=0"])
    assert not (tmp / "nodev_out.txt").exists()

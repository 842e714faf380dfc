"""The port's Python API (cxxnet_tpu_torch/wrapper/api.py) and C ABI
(cxxnet_tpu_torch/native/capi.cc) against the JAX package's, on the CPU.

* ``Net`` / ``DataIter`` / ``train`` / ``ServingHost`` against
  ``cxxnet_tpu.wrapper.api`` at ``dev = cpu``: the port's net takes the
  JAX net's weights through ``set_weight`` (the wrapper's own surface),
  both update on the same numpy batches and on the same ``DataIter``
  batches, then ``predict`` / ``extract`` / ``get_weight`` / ``evaluate``
  agree (forward 1e-6; after sgd steps, weights 5e-3 of their scale,
  the f32 grad envelope); the port's snapshot loads in the JAX package
  and the JAX package's in the port with equal predictions; the serving
  paths (``enable_serving``, ``ServingHost`` from 4 threads) return the
  rows ``predict`` does.
* the C ABI, as tests/test_capi.py drives native/: in process through
  ``ctypes`` (train / predict / get and set weight, an error message,
  the iterator surface) and from a fresh interpreter through the C demo
  (train, save, reload) and the ``cxxnet`` trainer binary, built under
  a file lock into ``cxxnet_tpu_torch/native/_build/`` (xdist workers
  race to build it); the port's ``capi.cc`` is held to ``native/capi.cc``
  line for line but its two imports.
"""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.wrapper import api as japi  # noqa: E402
from cxxnet_tpu_torch.wrapper import api  # noqa: E402

FWD_TOL = 1e-6
NET_GRAD_TOL = 5e-3

NET_CFG = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 8
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 3
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,6
batch_size = 16
updater = sgd
eta = 0.1
momentum = 0.9
metric = error
"""
CONV_CFG = """
netconfig=start
layer[+1:cv] = conv:cv
  nchannel = 4
  kernel_size = 5
  stride = 2
layer[+1] = relu
layer[+1] = max_pooling
  kernel_size = 2
  stride = 2
layer[+1] = flatten
layer[+1:fc] = fullc:fc
  nhidden = 10
layer[+0] = softmax
netconfig=end
input_shape = 1,28,28
batch_size = 16
updater = sgd
eta = 0.05
metric = error
"""
LAYERS = {NET_CFG: ("fc1", "fc2"), CONV_CFG: ("cv", "fc")}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(cfg):
    """(JAX Net, port Net) on ``cfg`` at dev = cpu, the port's weights
    written from the JAX net's through set_weight."""
    jn, tn = japi.Net(dev="cpu", cfg=cfg), api.Net(dev="cpu", cfg=cfg)
    for n in (jn, tn):
        n.set_param("silent", "1")
        n.init_model()
    for layer in LAYERS[cfg]:
        for tag in ("wmat", "bias"):
            tn.set_weight(jn.get_weight(layer, tag), layer, tag)
    return jn, tn


def _batches(n, shape, nclass, seed=0):
    rnd = np.random.RandomState(seed)
    return [(rnd.rand(*shape).astype(np.float32),
             rnd.randint(0, nclass, shape[0]).astype(np.float32))
            for _ in range(n)]


def test_net_updates_predicts_and_extracts_like_jax():
    jn, tn = _pair(NET_CFG)
    for x, y in _batches(4, (16, 1, 1, 6), 3):
        jn.update(x, y)
        tn.update(x, y)
    for layer in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            w = jn.get_weight(layer, tag)
            assert _rel(tn.get_weight(layer, tag), w) <= NET_GRAD_TOL
            tn.set_weight(w, layer, tag)
    x, _ = _batches(1, (16, 1, 1, 6), 3, seed=9)[0]
    np.testing.assert_array_equal(tn.predict(x), jn.predict(x))
    assert _rel(tn.extract(x, "2"), jn.extract(x, "2")) <= FWD_TOL
    assert tn.get_weight("nosuch", "wmat") is None
    with pytest.raises(ValueError, match="tag must be bias or wmat"):
        tn.get_weight("fc1", "gamma")
    with pytest.raises(ValueError, match="need label"):
        tn.update(x)


def test_snapshots_cross_both_ways(tmp_path):
    jn, tn = _pair(NET_CFG)
    x, y = _batches(1, (16, 1, 1, 6), 3)[0]
    tn.update(x, y)
    tn.save_model(str(tmp_path / "t.model"))
    jn2 = japi.Net(dev="cpu", cfg="batch_size = 16\nsilent = 1")
    jn2.load_model(str(tmp_path / "t.model"))
    np.testing.assert_array_equal(jn2.predict(x), tn.predict(x))
    jn.save_model(str(tmp_path / "j.model"))
    tn2 = api.Net(dev="cpu", cfg="batch_size = 16\nsilent = 1")
    tn2.load_model(str(tmp_path / "j.model"))
    np.testing.assert_array_equal(tn2.predict(x), jn.predict(x))
    tn3 = api.Net(dev="cpu", cfg=NET_CFG + "silent = 1\n")
    tn3.init_model()
    tn3.copy_model_from(str(tmp_path / "j.model"))
    np.testing.assert_array_equal(tn3.get_weight("fc2", "wmat"),
                                  jn.get_weight("fc2", "wmat"))


def _mnist(tmp_path, n=64):
    subprocess.run([sys.executable, os.path.join(REPO,
                                                 "tools/make_synth_mnist.py"),
                    "--out", str(tmp_path), "--train", str(n),
                    "--test", "32"], check=True, capture_output=True)
    return (f"iter = mnist\n"
            f"path_img = {tmp_path}/train-images-idx3-ubyte.gz\n"
            f"path_label = {tmp_path}/train-labels-idx1-ubyte.gz\n"
            f"input_flat = 0\nbatch_size = 16\n")


def test_data_iter_and_evaluate_match_jax(tmp_path):
    """DataIter yields the JAX DataIter's batches; a conv net updated on
    them (update(DataIter)), predicting and evaluating through them,
    agrees with the JAX net."""
    it_cfg = _mnist(tmp_path)
    ji, ti = japi.DataIter(it_cfg), api.DataIter(it_cfg)
    jn, tn = _pair(CONV_CFG)
    with pytest.raises(RuntimeError, match="head"):
        ti.get_data()
    n = 0
    ji.before_first()
    ti.before_first()
    while ti.next():
        assert ji.next()
        np.testing.assert_array_equal(ti.get_data(), ji.get_data())
        np.testing.assert_array_equal(ti.get_label(), ji.get_label())
        jn.update(ji)
        tn.update(ti)
        n += 1
    assert n == 4 and not ji.next()
    for layer in ("cv", "fc"):
        for tag in ("wmat", "bias"):
            w = jn.get_weight(layer, tag)
            assert _rel(tn.get_weight(layer, tag), w) <= NET_GRAD_TOL
            tn.set_weight(w, layer, tag)
    assert tn.evaluate(ti, "eval") == jn.evaluate(ji, "eval")
    ji.before_first()
    ti.before_first()
    assert ti.next() and ji.next()
    np.testing.assert_array_equal(tn.predict(ti), jn.predict(ji))
    assert _rel(tn.extract(ti, "cv"), jn.extract(ji, "cv")) <= FWD_TOL


def test_train_learns_like_jax(tmp_path):
    """The one-call loop over a DataIter with eval data in both packages:
    both nets fit the synthetic digits (the eval error of both under 0.5
    after 3 rounds; 0 is what both reach here)."""
    it_cfg = _mnist(tmp_path, n=512)
    cfg = CONV_CFG + "silent = 1\n"
    param = {"eta": "0.1", "momentum": "0.9"}
    jn = japi.train(cfg, japi.DataIter(it_cfg), 3, param,
                    eval_data=japi.DataIter(it_cfg), dev="cpu")
    tn = api.train(cfg, api.DataIter(it_cfg), 3, param,
                   eval_data=api.DataIter(it_cfg), dev="cpu")
    for net, it in ((jn, japi.DataIter(it_cfg)), (tn, api.DataIter(it_cfg))):
        err = float(net.evaluate(it, "eval").split(":")[1])
        assert err < 0.5, err


def test_serving_paths_answer_as_predict(tmp_path):
    """enable_serving routes predict through the micro-batcher with the
    same answers; a ServingHost over the saved snapshot answers 4
    client threads with the rows of the net's raw forward, as the JAX
    package's ServingHost does."""
    jn, tn = _pair(NET_CFG)
    x, _ = _batches(1, (16, 1, 1, 6), 3, seed=3)[0]
    want = tn.predict(x)
    tn.enable_serving("serve_shapes = 1,8,16")
    try:
        np.testing.assert_array_equal(tn.predict(x), want)
        with pytest.raises(RuntimeError, match="already"):
            tn.enable_serving()
    finally:
        tn.disable_serving()
    path = str(tmp_path / "m.model")
    tn.save_model(path)
    cfg = (f"model_in = {path}\nbatch_size = 16\nserve_shapes = 1,8\n"
           "silent = 1\n")
    raw = tn._trainer.forward_eval(
        __import__("torch").from_numpy(x), [tn._trainer.net.final_node])[0]
    raw = raw.reshape(16, -1)
    host = api.ServingHost(dev="cpu")
    jhost = japi.ServingHost(dev="cpu")
    try:
        host.add_model("m", cfg)
        jhost.add_model("m", cfg)
        assert host.models == ["m"]
        rows = [None] * 16

        def client(j):
            for i in range(j, 16, 4):
                rows[i] = host.predict("m", x[i:i + 1])

        ths = [threading.Thread(target=client, args=(j,),
                                name=f"cxxnet-test-client-{j}")
               for j in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        got = np.concatenate(rows)
        assert _rel(got, raw) <= FWD_TOL
        assert _rel(got, jhost.predict("m", x)) <= FWD_TOL
        assert host.retraces() == 0
    finally:
        host.close()
        jhost.close()


def test_dev_defaults_to_the_card():
    """A Net made without ``dev`` runs on the card: with no card it
    raises at init, naming ``dev = cpu``."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    n = api.Net(cfg=NET_CFG)
    with pytest.raises(RuntimeError, match="dev = cpu"):
        n.init_model()


# ------------------------------------------------------------------ C ABI
@pytest.fixture(scope="module")
def built():
    from cxxnet_tpu_torch.native import build
    try:
        return build.build()
    except build.CapiBuildError as e:
        pytest.fail(f"the port's C ABI does not build: {e}")


@pytest.fixture(scope="module")
def capi(built):
    lib = ctypes.CDLL(str(built["lib"]))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.CXNNetCreate.restype = ctypes.c_void_p
    lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.CXNNetFree.argtypes = [ctypes.c_void_p]
    lib.CXNNetSetParam.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.CXNNetInitModel.argtypes = [ctypes.c_void_p]
    lib.CXNNetUpdateBatch.argtypes = [ctypes.c_void_p, f32p, u64p,
                                      ctypes.c_int, f32p, u64p, ctypes.c_int]
    lib.CXNNetPredictBatch.restype = f32p
    lib.CXNNetPredictBatch.argtypes = [ctypes.c_void_p, f32p, u64p,
                                       ctypes.c_int, u64p, ip]
    lib.CXNNetExtractBatch.restype = f32p
    lib.CXNNetExtractBatch.argtypes = [ctypes.c_void_p, f32p, u64p,
                                       ctypes.c_int, ctypes.c_char_p, u64p,
                                       ip]
    lib.CXNNetGetWeight.restype = f32p
    lib.CXNNetGetWeight.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, u64p, ip]
    lib.CXNNetSetWeight.argtypes = [ctypes.c_void_p, f32p, ctypes.c_uint64,
                                    ctypes.c_char_p, ctypes.c_char_p]
    lib.CXNGetLastError.restype = ctypes.c_char_p
    lib.CXNIOCreateFromConfig.restype = ctypes.c_void_p
    lib.CXNIOCreateFromConfig.argtypes = [ctypes.c_char_p]
    lib.CXNIONext.argtypes = [ctypes.c_void_p]
    lib.CXNIOBeforeFirst.argtypes = [ctypes.c_void_p]
    lib.CXNIOGetData.restype = f32p
    lib.CXNIOGetData.argtypes = [ctypes.c_void_p, u64p, ip]
    lib.CXNIOGetLabel.restype = f32p
    lib.CXNIOGetLabel.argtypes = [ctypes.c_void_p, u64p, ip]
    lib.CXNIOFree.argtypes = [ctypes.c_void_p]
    return lib


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64(*vals):
    return (ctypes.c_uint64 * len(vals))(*vals)


def test_capi_train_predict_weights(capi):
    """Through ctypes in process: the net trains, its predictions and
    features equal the wrapper's on the same weights, and a weight
    written through the ABI reads back."""
    cfg = NET_CFG.encode() + b"silent = 1\n"
    net = capi.CXNNetCreate(b"cpu", cfg)
    assert net, capi.CXNGetLastError()
    assert capi.CXNNetInitModel(net) == 0, capi.CXNGetLastError()
    for x, y in _batches(30, (16, 1, 1, 6), 3):
        x[:, 0, 0, :3] += 2.0 * (y[:, None] == np.arange(3))
        assert capi.CXNNetUpdateBatch(net, _f32(x), _u64(16, 1, 1, 6), 4,
                                      _f32(y), _u64(16, 1), 2) == 0, \
            capi.CXNGetLastError()
    oshape, ondim = _u64(0, 0, 0, 0), ctypes.c_int(0)
    ref = api.Net(dev="cpu", cfg=NET_CFG + "silent = 1\n")
    ref.init_model()
    for layer in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            w = capi.CXNNetGetWeight(net, layer.encode(), tag.encode(),
                                     oshape, ctypes.byref(ondim))
            assert w, capi.CXNGetLastError()
            shape = tuple(oshape[:ondim.value])
            ref.set_weight(np.ctypeslib.as_array(w, shape=shape).copy(),
                           layer, tag)
    x, y = _batches(1, (16, 1, 1, 6), 3, seed=4)[0]
    x[:, 0, 0, :3] += 2.0 * (y[:, None] == np.arange(3))
    pred = capi.CXNNetPredictBatch(net, _f32(x), _u64(16, 1, 1, 6), 4,
                                   oshape, ctypes.byref(ondim))
    assert pred and ondim.value == 1
    got = np.ctypeslib.as_array(pred, shape=(16,)).copy()
    np.testing.assert_array_equal(got, ref.predict(x))
    assert (got == y).mean() > 0.8
    feat = capi.CXNNetExtractBatch(net, _f32(x), _u64(16, 1, 1, 6), 4,
                                   b"2", oshape, ctypes.byref(ondim))
    assert feat and tuple(oshape[:ondim.value]) == (16, 8)
    assert _rel(np.ctypeslib.as_array(feat, shape=(16, 8)),
                ref.extract(x, "2")) <= FWD_TOL
    w = np.full((3,), 0.25, np.float32)
    assert capi.CXNNetSetWeight(net, _f32(w), 3, b"fc2", b"bias") == 0
    back = capi.CXNNetGetWeight(net, b"fc2", b"bias", oshape,
                                ctypes.byref(ondim))
    np.testing.assert_array_equal(np.ctypeslib.as_array(back, shape=(3,)), w)
    assert not capi.CXNNetGetWeight(net, b"nosuch", b"wmat", oshape,
                                    ctypes.byref(ondim))
    assert ondim.value == 0
    capi.CXNNetFree(net)


def test_capi_bad_config_sets_error(capi):
    net = capi.CXNNetCreate(b"cpu", b"netconfig=start\nlayer[0->1] = nosuch\n"
                                    b"netconfig=end\nbatch_size=4\n"
                                    b"input_shape=1,1,4\n")
    if net:
        assert capi.CXNNetInitModel(net) != 0
        capi.CXNNetFree(net)
    assert b"nosuch" in capi.CXNGetLastError()


def test_capi_io_iterator(capi, tmp_path):
    it_cfg = _mnist(tmp_path).encode()
    it = capi.CXNIOCreateFromConfig(it_cfg)
    assert it, capi.CXNGetLastError()
    assert capi.CXNIOBeforeFirst(it) == 0
    ref = api.DataIter(it_cfg.decode())
    ref.before_first()
    nbatch = 0
    oshape, ondim = _u64(0, 0, 0, 0), ctypes.c_int(0)
    while capi.CXNIONext(it) == 1:
        assert ref.next()
        d = capi.CXNIOGetData(it, oshape, ctypes.byref(ondim))
        assert d and ondim.value == 4
        assert tuple(oshape) == (16, 1, 28, 28)
        np.testing.assert_array_equal(
            np.ctypeslib.as_array(d, shape=(16, 1, 28, 28)), ref.get_data())
        lab = capi.CXNIOGetLabel(it, oshape, ctypes.byref(ondim))
        assert lab and ondim.value == 2
        nbatch += 1
    assert nbatch == 4
    capi.CXNIOFree(it)


def test_capi_source_is_the_jax_packages_but_its_imports():
    """The port's ``capi.cc`` is ``native/capi.cc`` with its embedded
    helper importing ``cxxnet_tpu_torch`` for ``cxxnet_tpu``: past the
    leading comment, the two files differ in those imports alone, so a
    change to the one cannot leave the other behind."""
    def body(path):
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        assert text.startswith("/*")
        return text[text.index("*/") + 2:]

    ours = body("cxxnet_tpu_torch/native/capi.cc")
    theirs = body("native/capi.cc")
    assert theirs.count("from cxxnet_tpu.") == 2
    assert ours == theirs.replace("from cxxnet_tpu.",
                                  "from cxxnet_tpu_torch.")


def test_capi_demo_subprocess(built, tmp_path):
    """Fresh-interpreter embedding: the plain-C demo trains, saves,
    reloads and predicts on the CPU; its snapshot loads in the JAX
    package."""
    from cxxnet_tpu_torch.native import build
    model = str(tmp_path / "demo.model")
    r = subprocess.run([str(built["demo"]), "cpu", model],
                       capture_output=True, env=build.embed_env(),
                       timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"capi_demo: cpu accuracy" in r.stdout
    jn = japi.Net(dev="cpu", cfg="batch_size = 64\nsilent = 1")
    jn.load_model(model)
    assert jn.get_weight("fc1", "wmat").shape == (32, 16)


def test_cxxnet_binary_trains(built, tmp_path):
    """The port's ``cxxnet`` binary runs the train task from a conf."""
    from cxxnet_tpu_torch.native import build
    it_cfg = _mnist(tmp_path, n=256)
    conf = tmp_path / "t.conf"
    conf.write_text(
        "dev = cpu\ndata = train\n"
        + "".join(f"  {ln}\n" for ln in it_cfg.splitlines()
                  if not ln.startswith("batch_size"))
        + "iter = end\n" + CONV_CFG.replace("eta = 0.05", "eta = 0.1")
        + f"num_round = 2\nmodel_dir = {tmp_path}/models\nsilent = 1\n")
    r = subprocess.run([str(built["cxxnet"]), str(conf)],
                       capture_output=True, env=build.embed_env(),
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"train-error" in r.stderr
    assert (tmp_path / "models" / "0002.model").exists()

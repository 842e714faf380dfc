"""The port's inference and finetuning tasks against the JAX package, on
the CPU.

CLI against CLI: ``task = pred``, ``pred_raw``, ``extract`` (text and
binary rows, the ``.meta`` file) and ``finetune`` through
example/MNIST/MNIST_pred.conf and MNIST_CONV.conf, over
tools/make_synth_mnist.py data, from one MNIST_CONV snapshot that the
JAX package's CLI trained for two rounds.  Trainer against trainer:
``predict`` / ``predict_raw`` of padded batches, ``extract_feature`` of
the nodes that the relu -> pool reorder rewrites in a narrow AlexNet
(the read fixups), ``copy_model_from`` with a layer whose shape changed,
and the section scanner's iterators for each task.  Inputs are made with
numpy from a seed.

Tolerances: the predicted classes and the ``.meta`` widths are equal;
float rows (``pred_raw``, ``extract``) within 1e-5 of the largest value
(the f32 forward envelope, printed with ``%g``: 6 significant digits);
copied weights bitwise.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu import engine as jengine  # noqa: E402

ROW_TOL = 1e-5
#: images in the synthetic test set: three batches of 100, the last one
#: padded by 50 rows
N_TEST = 250


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def jopts():
    saved = jengine.snapshot()
    yield jengine.opts
    for k, v in saved.items():
        jengine.opts.set(k, v)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """Synthetic MNIST data, and an MNIST_CONV snapshot that the JAX CLI
    wrote after two rounds on it at eta 0.3 (test error 0 by then), with
    dropout off, so that a finetune round is the same in both
    packages."""
    from cxxnet_tpu.main import LearnTask as JTask
    saved = jengine.snapshot()
    root = tmp_path_factory.mktemp("mnist")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools/make_synth_mnist.py"),
                    "--out", str(root / "data"), "--train", "3000",
                    "--test", str(N_TEST)], check=True, capture_output=True)
    text = open(os.path.join(REPO, "example/MNIST/MNIST_CONV.conf")).read()
    text = text.replace("./data/", f"{root}/data/").replace(
        "threshold = 0.5", "threshold = 0.0")
    conv = root / "conv.conf"
    conv.write_text(text)
    pred = open(os.path.join(REPO, "example/MNIST/MNIST_pred.conf")).read()
    (root / "pred.conf").write_text(pred.replace("./data/", f"{root}/data/"))
    assert JTask().run([str(conv), "dev=cpu", "num_round=2", "max_round=2",
                        "eta=0.3", "save_model=2", f"model_dir={root}/models",
                        "silent=1"]) == 0
    for k, v in saved.items():
        jengine.opts.set(k, v)
    return root


def _run_both(mnist, tmp_path, args, out_name, capsys=None):
    """The pred conf through both CLIs with ``args``, each writing
    ``<tmp>/<package>/<out_name>``; returns the two paths (and each
    run's stderr under ``capsys``)."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    paths, errs = {}, {}
    for name, task in (("jax", JTask), ("port", TTask)):
        (tmp_path / name).mkdir(exist_ok=True)
        out = str(tmp_path / name / out_name)
        # keys after a command-line ``pred = file`` would land in its
        # (never closed) iterator section, so the output path goes last
        argv = [str(mnist / "pred.conf"),
                f"model_in={mnist}/models/0002.model", "input_flat=0",
                "silent=1"] + args + [f"pred={out}"]
        if capsys is not None:
            capsys.readouterr()
        assert task().run(argv) == 0
        paths[name] = out
        if capsys is not None:
            errs[name] = capsys.readouterr()
    return paths, errs


def test_cli_pred_matches_jax_cli(jopts, mnist, tmp_path):
    """task = pred: the two files are equal line for line, one class per
    valid test image (the padded tail batch's padding dropped); the port
    writes a ``latency`` record of its three batches, as the JAX package
    does."""
    import json
    sink = tmp_path / "m.jsonl"
    paths, _ = _run_both(mnist, tmp_path, ["pool_layout=hwcn",
                                           f"metrics_sink=jsonl:{sink}"],
                         "pred.txt")
    got = open(paths["port"]).read().splitlines()
    assert got == open(paths["jax"]).read().splitlines()
    assert len(got) == N_TEST and set(got) <= {str(c) for c in range(10)}
    # both runs append to the one sink: the JAX package's record, then
    # the port's
    lats = [r for r in map(json.loads, open(sink)) if r["kind"] == "latency"]
    assert [(r["op"], r["count"]) for r in lats] == [("pred", 3)] * 2
    assert set(lats[0]) == set(lats[1]) and lats[1]["p50"] > 0


def test_cli_pred_raw_matches_jax_cli(jopts, mnist, tmp_path):
    """task = pred_raw: the final node's rows within ROW_TOL of the JAX
    package's, each summing to 1 (softmax), their argmax the pred
    classes."""
    paths, _ = _run_both(mnist, tmp_path, ["task=pred_raw"], "raw.txt")
    got, want = (np.loadtxt(paths[k], ndmin=2) for k in ("port", "jax"))
    assert got.shape == want.shape == (N_TEST, 10)
    assert _rel(got, want) <= ROW_TOL
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("node,width", [("2", 32 * 7 * 7), ("5", 100)])
@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_cli_extract_matches_jax_cli(jopts, mnist, tmp_path, node, width,
                                     fmt):
    """task = extract of the pooled node 2 and the sigmoid node 5: the
    ``.meta`` files are equal (the row width), the rows within ROW_TOL,
    and a binary file holds exactly rows x width little-endian float32
    values, byte for byte as long as the JAX package's."""
    paths, _ = _run_both(mnist, tmp_path,
                         ["task=extract", f"extract_node_name={node}",
                          f"output_format={fmt}", "pool_layout=hwcn"],
                         "feat")
    metas = [open(paths[k] + ".meta").read() for k in ("port", "jax")]
    assert metas[0] == metas[1] == f"{width}\n"
    if fmt == "bin":
        sizes = [os.path.getsize(paths[k]) for k in ("port", "jax")]
        assert sizes[0] == sizes[1] == N_TEST * width * 4
        got, want = (np.fromfile(paths[k], "<f4").reshape(-1, width)
                     for k in ("port", "jax"))
    else:
        got, want = (np.loadtxt(paths[k], ndmin=2) for k in ("port", "jax"))
    assert got.shape == want.shape == (N_TEST, width)
    assert _rel(got, want) <= ROW_TOL


def test_cli_finetune_matches_jax_cli(jopts, mnist, tmp_path, capsys):
    """task = finetune of MNIST_CONV.conf from the snapshot through both
    CLIs: the same copied layers (all three, logged), and, every weight
    copied and dropout off, the same round: its metric lines are
    equal."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    lines = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        capsys.readouterr()
        t = task()
        assert t.run([str(mnist / "conv.conf"), "dev=cpu", "task=finetune",
                      f"model_in={mnist}/models/0002.model", "num_round=1",
                      "max_round=1", "save_model=0", "pool_layout=hwcn",
                      "fast_wgrad=hwcn"]) == 0
        io = capsys.readouterr()
        text = io.out + io.err
        copied = re.findall(r"copy_model_from: copied layers (\[.*\])", text)
        lines[name] = (copied, re.findall(r"(?m)^\[\d+\]\t.*$", text))
    assert t.net.copied_layers == ["cv1", "fc1", "fc2"]
    assert lines["port"][0] == lines["jax"][0] == ["['cv1', 'fc1', 'fc2']"]
    assert len(lines["port"][1]) == 1 and lines["port"][1] == lines["jax"][1]


def test_copy_model_from_matches_jax(jopts, mnist):
    """copy_model_from into MNIST_CONV with fc1 widened to 120: cv1 is
    copied bitwise from the snapshot in both packages, fc1 and fc2 (whose
    shapes changed) keep their fresh weights; bf16 nets get the copy
    rounded and their float32 masters refreshed."""
    import torch
    from __graft_entry__ import _make_trainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils import serializer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    text = open(mnist / "conv.conf").read()
    a, b = text.index("netconfig=start"), text.index("netconfig=end") + 13
    net = text[a:b].replace("nhidden = 100", "nhidden = 120") \
        + "\ninput_shape = 1,28,28\n"
    snap = str(mnist / "models/0002.model")
    _, src, _, _ = serializer.load_model(snap)
    for dtype in ("float32", "bfloat16"):
        keys = [("dtype", dtype), ("updater", "sgd"), ("momentum", "0.9"),
                ("silent", "1")]
        jt = _make_trainer(net, 100, "cpu", extra=keys)
        jt.copy_model_from(snap)
        tt = NetTrainer()
        for k, v in parse_config_string(net):
            tt.set_param(k, v)
        for k, v in [("batch_size", "100"), ("dev", "cpu")] + keys:
            tt.set_param(k, v)
        tt.init_model()
        tt._ensure_opt_state()
        fresh = {k: {t: p.clone() for t, p in g.items()}
                 for k, g in tt.params.items()}
        tt.copy_model_from(snap)
        assert tt.copied_layers == ["cv1"]
        for tag, p in tt.params["00-cv1"].items():
            want = np.asarray(jt.params["00-cv1"][tag], np.float32)
            np.testing.assert_array_equal(p.float().numpy(), want)
            np.testing.assert_array_equal(
                p.float().numpy(), torch.from_numpy(np.array(
                    src["00-cv1"][tag], np.float32)).to(p.dtype).float())
            if dtype == "bfloat16":
                assert torch.equal(tt.opt_state["00-cv1"][tag]["w32"],
                                   p.float())
        for key in ("04-fc1", "06-fc2"):
            for tag, p in tt.params[key].items():
                assert torch.equal(p, fresh[key][tag])


@pytest.fixture(scope="module")
def alexnet():
    """(JAX trainer, port trainer) of the narrow AlexNet at batch 4 under
    the CNN slice's options, the port's weights from the JAX trainer's;
    the JAX package's global options are restored after the module."""
    from test_torch_cnn import SLICE_OPTS, _SGD_KEYS, _alexnet_narrow, \
        _cnn_pair
    saved = jengine.snapshot()
    yield _cnn_pair(_alexnet_narrow(), 4, _SGD_KEYS + list(SLICE_OPTS))
    for k, v in saved.items():
        jengine.opts.set(k, v)


@pytest.mark.parametrize("node,fixup", [
    ("1", None),               # conv1: its one wgrad computes db, no fixup
    ("2", "relu"),             # relu1, moved behind pool1
    ("3", None),               # pool1 (the relu applied after it)
    ("5", "bias"),             # conv2, its bias moved to the pooled tensor
    ("6", "relu"),             # relu2, pre-activation and bias-less
    ("14", "relu"),            # relu5
])
def test_extract_of_reordered_nodes_matches_jax(alexnet, node, fixup):
    """extract_feature of a narrow AlexNet under the CNN slice's options
    (the relu -> pool reorder on): each node the reorder rewrote gets its
    relu and its conv bias back at read time, as in the JAX package:
    within FWD_TOL of the JAX trainer's extract_feature and of the same
    net with the reorder off."""
    from test_torch_cnn import _synth_batch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    jt, tt = alexnet
    nid = tt.net.node_id(node)
    assert tt._read_fixups.get(nid, (None,))[0] == fixup
    # the same rewrites as the JAX package's, but conv1's bias: the JAX
    # gate of the one-wgrad conv class reads the backend, so on the CPU
    # its conv1 defers the bias too
    jfix = {k: v[0] for k, v in jt._read_fixups.items()}
    assert jfix.pop(tt.net.node_id("1")) == "bias"
    assert {k: v[0] for k, v in tt._read_fixups.items()} == jfix
    batch = _synth_batch((4, 3, 67, 67), 10, 16)
    batch.num_batch_padd = 1
    got = tt.extract_feature(batch, node)
    want = jt.extract_feature(batch, node)
    assert got.shape == want.shape and got.shape[0] == 3
    assert _rel(got, want) <= 1e-6
    ref = NetTrainer()
    for k, v in tt.cfg:
        if k != "pool_relu_reorder":
            ref.set_param(k, v)
    ref.set_param("pool_relu_reorder", "0")
    ref.init_model()
    ref.set_state(tt.params, tt.buffers)
    assert not ref._read_fixups
    assert _rel(got, ref.extract_feature(batch, node)) <= 1e-6


@pytest.mark.parametrize("nclass", [10, 1])
def test_predict_matches_jax(jopts, nclass):
    """predict / predict_raw of a batch with 3 padding rows: only the
    valid rows; the argmax for more than one class, else the value."""
    from test_torch_cnn import _cnn_pair, _synth_batch
    net = f"""netconfig=start
layer[0->1] = flatten
layer[1->2] = fullc:fc1
  nhidden = {nclass}
layer[2->2] = {'softmax' if nclass > 1 else 'l2_loss'}
netconfig=end
input_shape = 1,4,4
"""
    jt, tt = _cnn_pair(net, 8, [])
    batch = _synth_batch((8, 1, 4, 4), max(nclass, 2), 17)
    batch.num_batch_padd = 3
    raw, want_raw = tt.predict_raw(batch), jt.predict_raw(batch)
    assert raw.shape == (5, nclass) and _rel(raw, want_raw) <= 1e-6
    pred = tt.predict(batch)
    np.testing.assert_array_equal(pred, jt.predict(batch)) if nclass > 1 \
        else np.testing.assert_allclose(pred, jt.predict(batch), rtol=1e-6)
    assert pred.shape == (5,)


@pytest.mark.parametrize("task", ["train", "finetune", "pred", "pred_raw",
                                  "extract"])
def test_section_scanner_opens_the_same_iterators(jopts, mnist, task):
    """The section scanner's quirks as in the JAX package: ``data`` and
    ``eval`` sections open for every task but ``pred``, the ``pred``
    section for pred / pred_raw / extract (and serve)."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils.config import parse_config_file
    pairs = parse_config_file(str(mnist / "conv.conf")) + [
        ("pred", "out.txt"), ("iter", "mnist"),
        ("path_img", f"{mnist}/data/t10k-images-idx3-ubyte.gz"),
        ("path_label", f"{mnist}/data/t10k-labels-idx1-ubyte.gz"),
        ("iter", "end"), ("task", task), ("silent", "1")]
    opened = {}
    for name, cls in (("jax", JTask), ("port", TTask)):
        t = cls()
        for k, v in pairs:
            t.set_param(k, v)
        t._create_iterators()
        opened[name] = (t.itr_train is not None, len(t.itr_evals),
                        t.itr_pred is not None)
        for it in [t.itr_train, t.itr_pred] + t.itr_evals:
            if it is not None:
                it.close()
    assert opened["port"] == opened["jax"]
    assert opened["port"] == ((task != "pred", int(task != "pred"),
                               task in ("pred", "pred_raw", "extract")))


@pytest.mark.parametrize("val,want", [("txt", 1), ("bin", 0), ("raw", 0)])
def test_output_format_matches_jax(val, want):
    """output_format: ``txt`` = text rows, anything else binary (with a
    warning for a spelling other than ``bin``), as in the JAX package."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    for cls in (JTask, TTask):
        t = cls()
        t.set_param("output_format", val)
        assert t.output_format == want


def test_extract_needs_a_node_and_a_pred_section(jopts, mnist, tmp_path):
    """task = extract without extract_node_name, and task = pred without
    a ``pred`` iterator section, fail before writing anything."""
    from cxxnet_tpu_torch.main import LearnTask
    snap = f"model_in={mnist}/models/0002.model"
    with pytest.raises(ValueError, match="extract_node_name"):
        LearnTask().run([str(mnist / "pred.conf"), snap, "input_flat=0",
                         "task=extract", "silent=1",
                         f"pred={tmp_path}/f.txt"])
    with pytest.raises(RuntimeError, match="pred iterator"):
        LearnTask().run([str(mnist / "conv.conf"), "dev=cpu", snap,
                         "task=pred", "silent=1"])
    assert not os.path.exists(tmp_path / "f.txt")

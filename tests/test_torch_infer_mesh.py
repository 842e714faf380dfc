"""The port's inference tasks on a mesh against one device and against
the JAX package, on the CPU.

One spawned group of four gloo ranks (``tests/torch_infer_mesh_ranks.py``)
runs the port's CLI inside the group, as the ranks the CLI spawns for a
``dev`` of several ids would: at world 4 ``task = pred``, ``pred_raw``
and ``extract`` (text and binary rows) of example/MNIST/MNIST_pred.conf
at ``dev = cpu:0-3`` and of example/MNIST/mesh.conf (``data:2,model:2``,
its MLP with a pred section), and ``pred_raw`` of example/LM/longctx.conf
(``data:2,seq:2``), moe_lm.conf (``data:2,expert:2``) and
pipeline_lm.conf on ``data:2,pipe:2`` (the JAX package runs all three
on its CPU mesh); then, as two groups of two, the MNIST tasks at ``dev =
cpu:0-1``, ``task = pred`` / ``extract`` with ``dev = cpu`` in the group
(the group is the mesh), micro-batched ``serve`` in each
``serve_dtype``, the wrapper API in the group, and the two serve
refusals.  The JAX package's CLI runs the same confs, snapshots and
``dev`` on conftest's host devices; the port's CLI runs them on one
device.  The test set's 250 images make a tail batch of 50 padding
rows.  Inputs are made with numpy from a seed; the MNIST snapshots are
trained here by the port's CLI.

Tolerances: class ids equal; float rows within 1e-6 of the largest
value (the f32 forward envelope), plus, for rows printed as text, one
unit of the printed value's sixth significant digit (``%g``); the
wrapper's parameters after one update within 1e-5 (the data-parallel
bound of tests/test_torch_dp.py); served rows within ``SERVE_TOL`` of
one device's f32 rows, f32 within the forward envelope.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import torch_infer_mesh_ranks as ranks  # noqa: E402
from cxxnet_tpu import engine as jengine  # noqa: E402
from test_torch_ring import write_init_model, write_lm_corpus  # noqa: E402

#: f32 forward envelope (ROADMAP ground rules), relative to the largest
ROW_TOL = 1e-6
#: parameters after a data-parallel update (tests/test_torch_dp.py)
PARAM_ATOL = 1e-5
#: test images: batches of 100, 100 and 50 valid rows + 50 padding rows
N_TEST = 250
EXTRACT_NODE = "5"
#: mesh.conf's MLP: fc1's output, 128 wide and model-sharded
MLP_NODE = "top[1]"
SERVE_ARGS = ["serve_shapes=2,8,32", "serve_clients=2", "serve_calib=1"]
#: the LM confs: (conf, mesh, batch, seqlen)
LM_CONFS = (("longctx", "data:2,seq:2", 8, 256),
            ("moe_lm", "data:2,expert:2", 8, 128),
            ("pipeline_lm", "data:2,pipe:2", 16, 128))
MNIST_TASKS = (("pred", ["task=pred"]), ("pred_raw", ["task=pred_raw"]),
               ("extract", ["task=extract", f"extract_node_name="
                            f"{EXTRACT_NODE}", "output_format=txt"]),
               ("extract_bin", ["task=extract", f"extract_node_name="
                                f"{EXTRACT_NODE}", "output_format=bin"]))
MLP_TASKS = (("pred", ["task=pred"]), ("pred_raw", ["task=pred_raw"]),
             ("extract_bin", ["task=extract", f"extract_node_name="
                              f"{MLP_NODE}", "output_format=bin"]))
WRAPPER_CFG = "batch_size = 100\neta = 0.1\nmomentum = 0.9\n"


def _port_mnist_snapshots(root):
    """Synthetic MNIST (3000 + 250 images), MNIST_CONV and mesh.conf's
    MLP trained by the port's CLI on one device (the conv net to test
    error 0 in two rounds with dropout off), and the confs the runs
    read: MNIST_pred.conf, mesh.conf with MNIST_pred.conf's pred
    section, serve.conf."""
    from cxxnet_tpu_torch.main import LearnTask
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools/make_synth_mnist.py"),
                    "--out", str(root / "data"), "--train", "3000",
                    "--test", str(N_TEST)], check=True, capture_output=True)

    def conf(name, src, extra=""):
        text = open(os.path.join(REPO, "example/MNIST", src)).read()
        (root / name).write_text(text.replace("./data/", f"{root}/data/")
                                 .replace("threshold = 0.5",
                                          "threshold = 0.0") + extra)
        return str(root / name)
    conv = conf("conv.conf", "MNIST_CONV.conf")
    pred_text = open(os.path.join(REPO, "example/MNIST/MNIST_pred.conf")) \
        .read()
    section = pred_text[pred_text.index("pred = out.txt"):
                        pred_text.index("iter = end")] + "iter = end\n"
    confs = {"conv": conv, "pred": conf("pred.conf", "MNIST_pred.conf"),
             "mesh": conf("mesh_pred.conf", "mesh.conf",
                          "\n" + section.replace("./data/",
                                                 f"{root}/data/")),
             "serve": conf("serve.conf", "serve.conf")}
    assert LearnTask().run([conv, "dev=cpu", "num_round=2", "max_round=2",
                            "eta=0.3", "save_model=2",
                            f"model_dir={root}/conv", "silent=1"]) == 0
    assert LearnTask().run([confs["mesh"], "dev=cpu", "mesh=data:1",
                            "num_round=1", "max_round=1", "save_model=1",
                            f"model_dir={root}/mlp", "silent=1"]) == 0
    return confs


def _lm_inputs(root):
    """Each LM conf's corpus of exactly two batches and its initial
    snapshot from the JAX package's trainer; the pred section's argv."""
    out = {}
    for name, mesh, batch, seqlen in LM_CONFS:
        d = root / name
        d.mkdir()
        conf = os.path.join(REPO, "example", "LM", f"{name}.conf")
        corpus = write_lm_corpus(d, batch, seqlen, steps=2)
        write_init_model(conf, str(d / "init.model"))
        out[name] = (conf, mesh, [f"model_in={d}/init.model",
                                  f"path_tok={corpus}"],
                     ["iter=text", f"path_tok={corpus}", "tok_count=4",
                      "iter=packseq", f"seqlen={seqlen}", "iter=end"])
    return out


class Runs:
    """Every run's output paths: ``path(package, label)``."""

    def __init__(self, root):
        self.root = root

    def path(self, who: str, label: str) -> str:
        d = self.root / who
        d.mkdir(exist_ok=True)
        return str(d / label)


def _mnist_argv(confs, root, extra, out):
    return [confs["pred"], f"model_in={root}/conv/0002.model",
            "input_flat=0", "silent=1"] + extra + [f"pred={out}"]


def _mlp_argv(confs, root, extra, out):
    return [confs["mesh"], f"model_in={root}/mlp/0001.model",
            "silent=1"] + extra + [f"pred={out}"]


def _lm_argv(lm, name, extra, out):
    conf, mesh, model, section = lm[name]
    return [conf, "silent=1", f"mesh={mesh}", "dev=cpu:0-3"] + model \
        + extra + [f"pred={out}"] + section


def _serve_argv(confs, root, extra, out):
    return [confs["serve"], f"model_in={root}/conv/0002.model",
            "input_flat=0", "silent=1"] + SERVE_ARGS + extra \
        + [f"metrics_sink=jsonl:{out}.jsonl", f"pred={out}"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The spawned group's runs, beside the JAX package's and the port's
    one-device runs of the same confs (made in this process while the
    ranks run)."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    saved = jengine.snapshot()
    root = tmp_path_factory.mktemp("infer_mesh")
    confs = _port_mnist_snapshots(root)
    lm = _lm_inputs(root)
    for k, v in saved.items():
        jengine.opts.set(k, v)
    runs = Runs(root)
    rows = root / "rows.npy"
    labels = root / "labels.npy"
    rnd = np.random.RandomState(3)
    np.save(rows, rnd.rand(100, 1, 28, 28).astype(np.float32))
    np.save(labels, rnd.randint(0, 10, (100,)).astype(np.float32))

    parts4 = []
    for label, extra in MNIST_TASKS:
        parts4.append((f"mnist4_{label}", _mnist_argv(
            confs, root, ["dev=cpu:0-3"] + extra,
            runs.path("port4", f"mnist_{label}"))))
    for label, extra in MLP_TASKS:
        parts4.append((f"mlp_{label}", _mlp_argv(
            confs, root, extra, runs.path("port4", f"mlp_{label}"))))
    for name, *_ in LM_CONFS:
        parts4.append((f"lm_{name}", _lm_argv(
            lm, name, ["task=pred_raw"], runs.path("port4", f"lm_{name}"))))
    group_a = [(f"mnist2_{label}", _mnist_argv(
        confs, root, ["dev=cpu:0-1"] + extra,
        runs.path("port2", f"mnist_{label}")))
        for label, extra in MNIST_TASKS]
    group_a += [("joined_pred", _mnist_argv(
        confs, root, ["dev=cpu", "task=pred"],
        runs.path("joined", "pred"))),
        ("joined_extract", _mnist_argv(
            confs, root, ["dev=cpu", "task=extract",
                          f"extract_node_name={EXTRACT_NODE}",
                          "output_format=bin"],
            runs.path("joined", "extract_bin")))]
    group_a += [(f"serve_{dt}", _serve_argv(
        confs, root, ["dev=cpu:0-1", f"serve_dtype={dt}"],
        runs.path("port2", f"serve_{dt}")))
        for dt in ("f32", "bf16", "int8")]
    group_a.append(("serve_undivided", ("raises", _serve_argv(
        confs, root, ["dev=cpu:0-1", "serve_shapes=1,8"],
        runs.path("port2", "serve_undivided")))))
    spec = {"dev": "cpu:0-1", "cfg": WRAPPER_CFG, "rows": str(rows),
            "labels": str(labels), "model": f"{root}/conv/0002.model",
            "node": EXTRACT_NODE, "layer": "fc1",
            "serve_cfg": "serve_shapes = 2,8,32\nserve_dtype = {dt}"}
    group_b = [(f"wrapper_{dt}", ("wrapper", dict(
        spec, serve_cfg=spec["serve_cfg"].format(dt=dt))))
        for dt in ("f32", "bf16", "int8")]
    group_b.append(("serve_gen", ("raises", [
        os.path.join(REPO, "example", "LM", "longctx.conf"), "task=serve",
        "serve_gen=1", "dev=cpu:0-1", "mesh=data:2", "silent=1"]
        + lm["longctx"][2] + [f"pred={runs.path('port2', 'gen')}"]
        + lm["longctx"][3])))

    box = {}

    def spawn():
        try:
            box["ranks"] = ranks.run_group(str(root), parts4,
                                           [group_a, group_b])
        except BaseException as e:  # noqa: BLE001 — raised below
            box["error"] = e
    th = threading.Thread(target=spawn)
    th.start()
    try:
        # the JAX package's CLI on its host devices, the port's on one
        for who, task, devs in (("jax", JTask, ("cpu:0-3", "cpu:0-1")),
                                ("port1", TTask, ("cpu",))):
            for dev in devs:
                tag = "" if who == "port1" else dev[-1]
                for label, extra in MNIST_TASKS:
                    assert task().run(_mnist_argv(
                        confs, root, [f"dev={dev}"] + extra,
                        runs.path(who + tag, f"mnist_{label}"))) == 0
            mlp_dev = ["dev=cpu", "mesh=data:1"] if who == "port1" else []
            for label, extra in MLP_TASKS:
                assert task().run(_mlp_argv(
                    confs, root, mlp_dev + extra,
                    runs.path(who, f"mlp_{label}"))) == 0
            for name, *_ in LM_CONFS:
                argv = _lm_argv(lm, name, ["task=pred_raw"],
                                runs.path(who, f"lm_{name}"))
                if who == "port1":
                    argv[2:4] = ["mesh=data:1", "dev=cpu"]
                assert task().run(argv) == 0
        for dt in ("f32", "bf16", "int8"):
            assert TTask().run(_serve_argv(
                confs, root, ["dev=cpu", f"serve_dtype={dt}"],
                runs.path("port1", f"serve_{dt}"))) == 0
    finally:
        th.join()
        for k, v in saved.items():
            jengine.opts.set(k, v)
    if "error" in box:
        raise box["error"]
    return {"root": root, "runs": runs, "ranks": box["ranks"],
            "confs": confs, "rows": rows, "labels": labels}


# ------------------------------------------------------------- readers
def _text_rows(path) -> np.ndarray:
    lines = open(path).read().splitlines()
    return np.array([line.split() for line in lines], np.float64)


def _digit_unit(want: np.ndarray) -> np.ndarray:
    """One unit of the sixth significant digit of each printed value
    (``%g``)."""
    mag = np.floor(np.log10(np.maximum(np.abs(want), 1e-37)))
    return 10.0 ** (mag - 5)


def _assert_rows_close(got, want, printed: bool, what: str):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = ROW_TOL * np.abs(want).max()
    if printed:
        tol = tol + _digit_unit(want)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} values off, worst "
                           f"{np.abs(got - want).max():.3g}")


def _read(runs, who, label):
    path = runs.path(who, label)
    if label.endswith("_bin"):
        width = int(open(path + ".meta").read())
        return np.fromfile(path, "<f4").reshape(-1, width)
    return _text_rows(path)


def _compare(runs, got_who, want_who, label):
    got, want = _read(runs, got_who, label), _read(runs, want_who, label)
    if label.endswith("pred") and not label.endswith("raw"):
        assert got.shape == want.shape and (got == want).all(), (
            f"{label}: {got_who} vs {want_who}: class ids differ")
    else:
        _assert_rows_close(got, want, not label.endswith("_bin"),
                           f"{label}: {got_who} vs {want_who}")


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("ndev", [4, 2])
@pytest.mark.parametrize("label", [t for t, _ in MNIST_TASKS])
def test_mnist_pred_tasks_on_a_data_mesh(work, ndev, label):
    """MNIST_pred.conf at ``dev = cpu:0-3`` and ``cpu:0-1``: every row
    once, in order, the tail batch's padding dropped; equal to one
    device and to the JAX package's run at the same ``dev``."""
    runs = work["runs"]
    got = _read(runs, f"port{ndev}", f"mnist_{label}")
    assert got.shape[0] == N_TEST
    _compare(runs, f"port{ndev}", "port1", f"mnist_{label}")
    _compare(runs, f"port{ndev}", f"jax{ndev - 1}", f"mnist_{label}")
    if label.startswith("extract"):
        meta = open(runs.path(f"port{ndev}", f"mnist_{label}")
                    + ".meta").read()
        assert meta == open(runs.path("port1", f"mnist_{label}")
                            + ".meta").read()


@pytest.mark.parametrize("label", [t for t, _ in MLP_TASKS])
def test_mesh_conf_pred_tasks_on_data_and_model(work, label):
    """example/MNIST/mesh.conf (``data:2,model:2``, fullc_gather = 1):
    the eval forward gathers the model axis's shards as ``evaluate``
    does; equal to one device and to the JAX package's mesh run."""
    runs = work["runs"]
    for r in work["ranks"]:
        assert r["world4"][f"mlp_{label}"]["mesh"] == {"data": 2,
                                                       "model": 2}
    _compare(runs, "port4", "port1", f"mlp_{label}")
    _compare(runs, "port4", "jax", f"mlp_{label}")


@pytest.mark.parametrize("name,mesh", [c[:2] for c in LM_CONFS])
def test_lm_confs_pred_raw_on_seq_expert_pipe(work, name, mesh):
    """longctx.conf on ``data:2,seq:2`` (each rank's block of the
    positions joined over seq), moe_lm.conf on ``data:2,expert:2`` and
    pipeline_lm.conf on ``data:2,pipe:2`` (the last stage's rows reach
    every rank): where the JAX package runs ``pred_raw`` on the mesh,
    the port runs it, equal to one device and to the JAX package."""
    runs = work["runs"]
    axes = dict(a.split(":") for a in mesh.split(","))
    assert work["ranks"][0]["world4"][f"lm_{name}"]["mesh"] == \
        {k: int(v) for k, v in axes.items()}
    _compare(runs, "port4", "port1", f"lm_{name}")
    _compare(runs, "port4", "jax", f"lm_{name}")


def test_pred_in_a_joined_group_writes_each_row_once(work):
    """``dev = cpu`` inside a joined group of two ranks: the group is a
    ``data`` mesh; ``task = pred`` and ``task = extract`` write every
    row exactly once, in order, from rank 0 only (one device's file,
    line for line; the binary rows within the forward envelope)."""
    runs = work["runs"]
    r0, r1 = work["ranks"][:2]
    assert r0["world2"]["joined_pred"]["mesh"] == {"data": 2}
    assert r1["world2"]["joined_pred"]["mesh"] == {"data": 2}
    got = open(runs.path("joined", "pred")).read()
    assert got == open(runs.path("port1", "mnist_pred")).read()
    assert len(got.splitlines()) == N_TEST
    ext = runs.path("joined", "extract_bin")
    assert open(ext + ".meta").read() == open(
        runs.path("port1", "mnist_extract_bin") + ".meta").read()
    _assert_rows_close(_read(runs, "joined", "extract_bin"),
                       _read(runs, "port1", "mnist_extract_bin"), False,
                       "joined extract")


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_serve_on_two_ranks(work, dt):
    """Micro-batched serve.conf on two ranks (buckets 2, 8, 32): every
    request answered, no retrace, the served classes those of one
    device's serve in f32; the variant's pairtest against f32, made on
    the mesh, within SERVE_TOL; one ``serve`` record (rank 0's)."""
    from cxxnet_tpu_torch.serve.engine import SERVE_TOL
    runs = work["runs"]
    got = open(runs.path("port2", f"serve_{dt}")).read().splitlines()
    one = open(runs.path("port1", f"serve_{dt}")).read().splitlines()
    assert len(got) == N_TEST
    if dt == "f32":
        assert got == one
        assert got == open(runs.path("port1", "mnist_pred")).read() \
            .splitlines()
    recs = [json.loads(x) for x in
            open(runs.path("port2", f"serve_{dt}") + ".jsonl")]
    [srv] = [r for r in recs if r["kind"] == "serve"]
    assert srv["retraces"] == 0 and srv["requests"] == N_TEST
    if dt != "f32":
        assert srv["quant_rel_err"] <= SERVE_TOL[dt]


def test_serve_refusals_use_the_jax_words(work):
    """``serve_shapes`` that the data axis does not divide, and
    ``serve_gen = 1`` on a mesh, are refused on every rank in the JAX
    package's words."""
    a0, a1, b0, b1 = work["ranks"]
    want = ("serve_shapes [1] not divisible by the mesh data axis (2); "
            "every bucket shards over it")
    assert a0["world2"]["serve_undivided"]["raised"] == want
    assert a1["world2"]["serve_undivided"]["raised"] == want
    gen = ("incremental decode runs single-device for now (mesh has 2 "
           "devices); drop the mesh_shape for task=serve generation")
    assert b0["world2"]["serve_gen"]["raised"] == gen
    assert b1["world2"]["serve_gen"]["raised"] == gen


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_wrapper_in_a_group_of_two(work, dt):
    """``Net(dev = "cpu:0-1")`` in a spawned group of two: ``predict``
    and ``extract`` return every row on both ranks, equal to one device;
    its serving path (rank 0 serves, rank 1 follows) answers within
    SERVE_TOL of one device's f32 rows; one ``update`` moves the
    weights as one device's does."""
    from cxxnet_tpu_torch.serve.engine import SERVE_TOL
    from cxxnet_tpu_torch.wrapper.api import Net, _as_batch
    rows = np.load(work["rows"])
    labels = np.load(work["labels"])
    model = f"{work['root']}/conv/0002.model"
    net = Net(dev="cpu", cfg=WRAPPER_CFG)
    net.load_model(model)
    pred = net.predict(rows)
    ext = net.extract(rows, EXTRACT_NODE)
    raw = net._trainer.predict_raw(_as_batch(rows, None))
    net.start_round(1)
    net.update(rows, labels)
    weight = net.get_weight("fc1", "wmat")
    r0, r1 = (work["ranks"][2]["world2"][f"wrapper_{dt}"],
              work["ranks"][3]["world2"][f"wrapper_{dt}"])
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for r in (r0, r1):
        assert np.array_equal(np.array(r["pred"]), pred)
        _assert_rows_close(r["extract"], ext, False, "wrapper extract")
        np.testing.assert_allclose(np.array(r["weight"]), weight, rtol=0,
                                   atol=PARAM_ATOL)
    assert "serve" not in r1
    if dt == "f32":
        assert np.array_equal(np.array(r0["serve_pred"]), pred)
    served = np.array(r0["serve"])
    err = np.abs(served - raw).max() / (np.abs(raw).max() + 1e-6)
    assert err <= (ROW_TOL if dt == "f32" else SERVE_TOL[dt]), err


def test_wrapper_outside_a_group_is_refused_with_the_trainer_words():
    """Several ids outside a process group: the net refuses to build, in
    the trainer's words, which name ``parallel.mesh.spawn`` (the port
    runs one process a device)."""
    from cxxnet_tpu_torch.wrapper.api import Net
    net = Net(dev="cpu:0-1", cfg=WRAPPER_CFG + """
netconfig=start
layer[+1] = fullc:fc1
  nhidden = 10
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
""")
    with pytest.raises(ValueError, match="no process group.*"
                       "parallel.mesh.spawn"):
        net.init_model()


def test_cli_spawns_the_ranks_of_a_pred_run(work, tmp_path):
    """``task = pred`` with ``dev = cpu:0-1`` from the CLI itself: it
    spawns the two ranks and writes one device's file."""
    from cxxnet_tpu_torch.main import LearnTask
    out = str(tmp_path / "pred.txt")
    assert LearnTask().run(_mnist_argv(work["confs"], work["root"],
                                       ["dev=cpu:0-1", "task=pred"],
                                       out)) == 0
    assert open(out).read() == open(
        work["runs"].path("port1", "mnist_pred")).read()

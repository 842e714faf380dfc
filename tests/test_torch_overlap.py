"""The port's bucketed overlapped reduction (``dp_overlap = 1``) and the
data-parallel CLI, on the CPU.

* Bucket plans: ``cxxnet_tpu_torch.parallel.overlap.plan_buckets`` on
  the trainer ``task = check`` builds (a virtual ``data:4`` mesh on
  meta) equals the JAX package's ``plan_buckets`` on its ``cpu:0-3``
  mesh: the same segments, keys per bucket (the deferred conv bias of
  the relu -> pool reorder included), tail keys and frontier.
* Two gloo ranks (``data:2``, f32): the overlapped step against the
  implicit one, BITWISE (a sum of two terms does not depend on its
  order; each gradient is the same local backward's) on the plain,
  tail-mask, ZeRO and ``dp_reduce_at = step`` configs;
  ``dp_reduce_dtype = bf16`` within tests/test_overlap.py's bf16 bound
  (losses 5% relative, parameters 0.1 relative + 5e-3 absolute); a
  dropout net takes one device's masks.
* The CLI: ``dev = cpu:0-1`` trains two ranks and only rank 0 prints
  round lines; ``continue = 1`` on the mesh ends bitwise equal to the
  uninterrupted run; a rank killed mid-round fails the command within
  the join timeout; the ``CXN_*`` launch of two processes ends with
  identical snapshots (tests/test_distributed.py's counterpart).
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import torch_dp_ranks as ranks  # noqa: E402
from cxxnet_tpu import engine  # noqa: E402
from test_overlap import CONV_NET, MESH_NET, MLP_ZERO_NET  # noqa: E402

from __graft_entry__ import _make_trainer  # noqa: E402

#: tests/test_overlap.py's bf16-wire bound
BF16_LOSS_RTOL = 0.05
BF16_PARAM_RTOL, BF16_PARAM_ATOL = 0.1, 5e-3
#: a CLI run of two ranks must end within this (a hang fails the test)
CLI_TIMEOUT_SEC = 120


# ----------------------------------------------------------- bucket plans

@pytest.mark.parametrize("net,mesh,extra,mb", [
    (CONV_NET, "data:4", (), "0.001"),
    (CONV_NET, "data:4", (), "0.01"),
    (CONV_NET, "data:4", (), "4"),
    (MLP_ZERO_NET, "data:4", (("shard_opt_state", "1"),), "0.001"),
    (MESH_NET, "data:2,model:2", (("fullc_gather", "1"),), "0.001"),
], ids=["conv_tiny", "conv_small", "conv_default", "mlp_zero", "mesh"])
def test_bucket_plan_equals_jax(net, mesh, extra, mb):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    saved = {k: getattr(engine.opts, k) for k in ("dp_overlap",
                                                  "dp_bucket_mb")}
    try:
        engine.opts.set("dp_overlap", "1")
        engine.opts.set("dp_bucket_mb", mb)
        jt = _make_trainer(net, 16, "cpu:0-3",
                           extra=[("mesh", mesh)] + list(extra))
        jplan = jt._dp_overlap_plan()
    finally:
        for k, v in saved.items():
            engine.opts.set(k, v)
    pt = NetTrainer()
    for k, v in parse_config_string(net):
        pt.set_param(k, v)
    for k, v in (("batch_size", "16"), ("dev", "cpu:0-3"), ("mesh", mesh),
                 ("dp_overlap", "1"), ("dp_bucket_mb", mb)) + extra:
        pt.set_param(k, v)
    pt.init_model(torch.device("meta"))
    pplan = pt._dp_overlap_plan()
    assert pplan is not None and jplan is not None
    assert pplan.stages == jplan.stages
    assert pplan.stage_keys == jplan.stage_keys
    assert pplan.tail_keys == jplan.tail_keys
    assert pplan.frontier == list(jplan.frontier)
    assert pplan.body_end == jplan.body_end
    assert pplan.bucket_bytes == jplan.bucket_bytes


# ------------------------------------------------- two ranks, in process

def _case(net, extra, **kw):
    return dict(net=net, extra=tuple(extra) + (("dp_bucket_mb", "0.001"),),
                steps=kw.get("steps", 4), shape=kw.get("shape", (3, 16, 16)),
                tail_padd=kw.get("tail_padd", 0))


#: (id, net, extra pairs, kw): each run with dp_overlap 0 and 1
BITWISE = [
    ("plain", CONV_NET, (), {}),
    ("tail_mask", CONV_NET, (), {"tail_padd": 5}),
    ("zero", MLP_ZERO_NET, (("shard_opt_state", "1"),),
     {"shape": (1, 1, 144)}),
    ("update_period_step", CONV_NET, (("update_period", "2"),
                                      ("dp_reduce_at", "step")), {}),
]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ov")
    cases = []
    for _, net, extra, kw in BITWISE:
        for ov in ("0", "1"):
            cases.append(_case(net, tuple(extra) + (("dp_overlap", ov),),
                               **kw))
    cases.append(_case(CONV_NET, (("dp_overlap", "1"),
                                  ("dp_reduce_dtype", "bf16")), steps=3))
    cases.append(_case(CONV_NET, (("dp_overlap", "1"),), steps=3))
    cases.append(_case(DROPOUT_NET, (), shape=(1, 1, 144)))
    return ranks.run_group(cases, out, 2)


DROPOUT_NET = MLP_ZERO_NET.replace(
    "layer[1->2] = relu\n",
    "layer[1->2] = relu\nlayer[2->2] = dropout\n  threshold = 0.5\n")


def test_dropout_masks_are_the_one_device_masks(two_ranks):
    """A rank draws the dropout mask of the whole batch and keeps its
    rows, so on two ranks a dropout net takes one device's masks: the
    per-step losses within 1e-6 relative and the parameters within 1e-5
    of the one-device run's (tests/test_torch_dp.py's bounds)."""
    two = two_ranks[-1]
    one = ranks.train_case(_case(DROPOUT_NET, (), shape=(1, 1, 144)), "cpu")
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-6,
                               atol=0)
    a, b = dict(_leaves(two["state"]["params"])), \
        dict(_leaves(one["state"]["params"]))
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("i", range(len(BITWISE)),
                         ids=[b[0] for b in BITWISE])
def test_overlap_matches_implicit_bitwise_on_two_ranks(two_ranks, i):
    """data:2 at f32: per-step losses, parameters, optimizer state and
    buffers of the overlapped step equal the implicit step's, bitwise;
    both ran the reductions they claim (the bucket plan was built for
    the overlapped run only) and the replicas agree after every step."""
    off, on = two_ranks[2 * i], two_ranks[2 * i + 1]
    assert on["buckets"] and off["buckets"] is None
    assert off["losses"] == on["losses"]
    a, b = dict(_leaves(off["state"])), dict(_leaves(on["state"]))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert off["drift"] == on["drift"] == [0.0] * 4


def test_bf16_wire_tracks_f32(two_ranks):
    """dp_reduce_dtype = bf16: finite, within tests/test_overlap.py's
    bf16 bound of the f32 wire's trajectory."""
    bf16, f32 = two_ranks[-3], two_ranks[-2]
    assert np.isfinite(bf16["losses"]).all()
    np.testing.assert_allclose(bf16["losses"], f32["losses"],
                               rtol=BF16_LOSS_RTOL)
    pa, pb = dict(_leaves(bf16["state"]["params"])), \
        dict(_leaves(f32["state"]["params"]))
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(),
                                   rtol=BF16_PARAM_RTOL,
                                   atol=BF16_PARAM_ATOL, err_msg=k)
    assert bf16["drift"] == [0.0] * 3


# ---------------------------------------------------------------- the CLI

MLP = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 16
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
layer[3->3] = softmax
netconfig=end
input_shape = 1,1,144
"""


def _write_conf(tmp_path, extra=""):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_synth_mnist as sm
    rnd = np.random.RandomState(0)
    labels = rnd.randint(0, 4, 128)
    imgs = np.stack([np.clip(sm.class_pattern(lb, 12, 12) * 255
                             + rnd.rand(12, 12) * 16, 0, 255)
                     for lb in labels])
    sm.write_idx_images(str(tmp_path / "img.gz"), imgs)
    sm.write_idx_labels(str(tmp_path / "lbl.gz"), labels)
    conf = tmp_path / "dp.conf"
    conf.write_text(f"""
data = train
iter = mnist
  path_img = {tmp_path}/img.gz
  path_label = {tmp_path}/lbl.gz
iter = end
eval = test
iter = mnist
  path_img = {tmp_path}/img.gz
  path_label = {tmp_path}/lbl.gz
iter = end
{MLP}
batch_size = 16
eta = 0.1
momentum = 0.9
metric = error
save_model = 1
print_step = 4
shard_opt_state = 1
test_on_server = 1
{extra}
""")
    return conf


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("CXN_COORDINATOR", None)
    return env


def _cli(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch", *map(str, args)],
        env=_env(), capture_output=True, text=True, timeout=CLI_TIMEOUT_SEC,
        **kw)


def _state(path):
    from cxxnet_tpu_torch.nnet.trainer import read_snapshot
    _, params, buffers, opt, _ = read_snapshot(str(path))
    return dict(_leaves({"params": params, "opt": opt or {}}))


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_two_ranks_train_and_continue_bitwise(tmp_path):
    """dev = cpu:0-1: two gloo ranks train (ZeRO, the replica check every
    round), only rank 0 prints its round lines, which are one device's
    (the train and eval metrics count the global batch), and writes the
    snapshots; a run cut after round 2 and resumed with continue = 1
    ends bitwise equal to the uninterrupted 3-round run."""
    conf = _write_conf(tmp_path)
    full = _cli([conf, "dev=cpu:0-1", "num_round=3",
                 f"model_dir={tmp_path}/full"])
    assert full.returncode == 0, full.stderr[-3000:]
    rounds = [ln for ln in full.stderr.splitlines()
              if ln.startswith("[") and "train-error" in ln]
    assert [ln.split("]")[0] for ln in rounds] == ["[1", "[2", "[3"]
    one = _cli([conf, "dev=cpu", "num_round=3", f"model_dir={tmp_path}/one"])
    assert one.returncode == 0, one.stderr[-3000:]
    assert rounds == [ln for ln in one.stderr.splitlines()
                      if ln.startswith("[") and "train-error" in ln]
    assert "test-error" in rounds[0]
    cut = _cli([conf, "dev=cpu:0-1", "num_round=2",
                f"model_dir={tmp_path}/cut"])
    assert cut.returncode == 0, cut.stderr[-3000:]
    resumed = _cli([conf, "dev=cpu:0-1", "num_round=3", "continue=1",
                    f"model_dir={tmp_path}/cut"])
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "Continue training from round 3" in resumed.stdout
    _assert_same_state(_state(tmp_path / "full" / "0003.model"),
                       _state(tmp_path / "cut" / "0003.model"))


def _rank_pids(parent: int):
    """The spawned rank processes under ``parent``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == parent and b"spawn_main" in cmd:
            out.append(int(pid))
    return sorted(out)


def test_cli_rank_killed_mid_round_fails_the_command(tmp_path):
    """A rank SIGKILLed mid-run makes the command exit non-zero within
    the timeout; the other rank is stopped, not left in a collective."""
    conf = _write_conf(tmp_path, "print_step = 1\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", str(conf),
         "dev=cpu:0-1", "num_round=1000", "save_model=0",
         f"model_dir={tmp_path}/m"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in p.stdout:
            if line.startswith("[1]"):
                break
        pids = _rank_pids(p.pid)
        assert len(pids) == 2, pids
        os.kill(pids[-1], signal.SIGKILL)
        t0 = time.monotonic()
        p.stdout.read()
        rc = p.wait(timeout=CLI_TIMEOUT_SEC)
    finally:
        if p.poll() is None:
            p.kill()
    assert rc != 0
    assert time.monotonic() - t0 < CLI_TIMEOUT_SEC
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}") or \
            open(f"/proc/{pid}/stat").read().split()[2] == "Z"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cxn_launch_two_processes_identical_snapshots(tmp_path):
    """CXN_COORDINATOR / CXN_NUM_PROC / CXN_PROC_RANK: two processes join
    one gloo group (each reads its shard of the data: dist_num_worker /
    dist_worker_rank), each writes its own snapshots, and their round-3
    snapshots hold the same arrays."""
    conf = _write_conf(tmp_path, "dev = cpu\n")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _env()
        env.update(CXN_COORDINATOR=f"127.0.0.1:{port}", CXN_NUM_PROC="2",
                   CXN_PROC_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch", str(conf),
             "num_round=3", f"model_dir={tmp_path}/m{rank}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate(timeout=CLI_TIMEOUT_SEC)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    _assert_same_state(_state(tmp_path / "m0" / "0003.model"),
                       _state(tmp_path / "m1" / "0003.model"))
    m0 = [ln for ln in outs[0].splitlines() if "train-error" in ln]
    m1 = [ln for ln in outs[1].splitlines() if "train-error" in ln]
    assert m0 and m0 == m1

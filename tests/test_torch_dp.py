"""The port's data-parallel plane against the JAX package, on the CPU.

The port runs ``mesh = data:4`` (and ``data:2,model:2``) as four gloo
ranks spawned by ``cxxnet_tpu_torch.parallel.mesh.spawn`` (one spawned
group trains every case, ``tests/torch_dp_ranks.py``); the JAX package
runs the same config on its ``cpu:0-3`` mesh of host devices.  Both
start from the JAX package's initial weights (``params_from_jax``) and
read the same seeded numpy batches (``tests/test_overlap.py``'s).

* Parity, 4 steps: ``CONV_NET`` and ``MLP_ZERO_NET`` of
  tests/test_overlap.py — plain, tail mask, ``shard_opt_state = 1``,
  ``update_period = 2`` under both ``dp_reduce_at`` values,
  ``dp_overlap`` 0 and 1 — a ``batch_norm`` net (the global batch's
  statistics) and mesh.conf's MLP on ``data:2,model:2`` under
  ``fullc_gather = 1``.  Bounds: per-step losses within 1e-6 relative,
  parameters within 1e-5 absolute (the bounds tests/test_torch_cnn.py
  holds single-device trajectories to); the replicas agree bitwise
  after every step (``check_weight_consistency`` == 0.0).
* The same run against the port on one device at the global batch,
  within the same bounds.
* A ZeRO ``data:4`` run's ``.ckpt`` holds the logical arrays: the JAX
  package's trainer loads it on its mesh and holds rank 0's state,
  bitwise.
* The fallback gates of ``dp_overlap = 1`` warn once each, in the JAX
  package's words; on one device there is no process group, no hook
  and no collective.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import jax  # noqa: E402

import torch_dp_ranks as ranks  # noqa: E402
from cxxnet_tpu import engine  # noqa: E402
from cxxnet_tpu.io.data import DataBatch as JBatch  # noqa: E402
from test_overlap import CONV_NET, MLP_ZERO_NET  # noqa: E402

from __graft_entry__ import _make_trainer  # noqa: E402

#: per-step loss bound (relative) and parameter bound (absolute)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5

BN_NET = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 32
layer[1->2] = batch_norm
layer[2->3] = relu
layer[3->4] = fullc:fc2
  nhidden = 4
layer[4->4] = softmax
netconfig=end
input_shape = 1,1,144
metric = error
eta = 0.1
momentum = 0.9
silent = 1
"""


def _mesh_conf_net() -> str:
    """example/MNIST/mesh.conf's netconfig, its update keys and
    fullc_gather (the data sections and dev / mesh left out)."""
    lines = open(os.path.join(REPO, "example", "MNIST",
                              "mesh.conf")).read().splitlines()
    a = lines.index("netconfig=start")
    b = lines.index("netconfig=end")
    return "\n".join(lines[a:b + 1]) + """
input_shape = 1,1,784
eta = 0.1
momentum = 0.9
metric = error
silent = 1
"""


MESH_NET = _mesh_conf_net()

DP_OPTS = ("dp_overlap", "dp_bucket_mb", "dp_reduce_dtype", "dp_reduce_at")

#: (id, net, extra pairs, mesh, kw): the parity cases
CASES = [
    ("plain", CONV_NET, (), "data:4", {}),
    ("plain_overlap", CONV_NET, (("dp_overlap", "1"),), "data:4", {}),
    ("tail_mask", CONV_NET, (), "data:4", {"tail_padd": 5}),
    ("tail_mask_overlap", CONV_NET, (("dp_overlap", "1"),), "data:4",
     {"tail_padd": 5}),
    ("zero", MLP_ZERO_NET, (("shard_opt_state", "1"),), "data:4",
     {"shape": (1, 1, 144)}),
    ("zero_overlap", MLP_ZERO_NET, (("shard_opt_state", "1"),
                                    ("dp_overlap", "1")), "data:4",
     {"shape": (1, 1, 144)}),
    ("update_period", CONV_NET, (("update_period", "2"),), "data:4", {}),
    ("update_period_step", CONV_NET, (("update_period", "2"),
                                      ("dp_overlap", "1"),
                                      ("dp_reduce_at", "step")),
     "data:4", {}),
    ("update_period_apply", CONV_NET, (("update_period", "2"),
                                       ("dp_overlap", "1"),
                                       ("dp_reduce_at", "apply")),
     "data:4", {}),
    ("batch_norm", BN_NET, (), "data:4", {"shape": (1, 1, 144)}),
    ("batch_norm_tail", BN_NET, (), "data:4",
     {"shape": (1, 1, 144), "tail_padd": 5}),
    ("fullc_gather", MESH_NET, (("fullc_gather", "1"),), "data:2,model:2",
     {"shape": (1, 1, 784)}),
    ("fullc_gather_overlap", MESH_NET, (("fullc_gather", "1"),
                                        ("dp_overlap", "1")),
     "data:2,model:2", {"shape": (1, 1, 784)}),
]


def _jax_run(net, extra, mesh, kw):
    """The JAX package on its cpu:0-3 mesh: (initial params and buffers
    as numpy, per-step losses, final params / opt state / buffers)."""
    saved = {k: getattr(engine.opts, k) for k in DP_OPTS}
    try:
        engine.opts.set("dp_bucket_mb", "0.001")
        for k, v in extra:
            if k in DP_OPTS:
                engine.opts.set(k, v)
        t = _make_trainer(net, 16, "cpu:0-3", extra=[("mesh", mesh)] + [
            kv for kv in extra if kv[0] not in DP_OPTS])
        init = (jax.tree.map(np.asarray, t.params),
                jax.tree.map(np.asarray, t.buffers))
        t.start_round(1)
        losses = []
        for data, label, padd in ranks.batches(
                4, shape=kw.get("shape", (3, 16, 16)),
                tail_padd=kw.get("tail_padd", 0)):
            b = JBatch(data=data, label=label,
                       index=np.arange(16, dtype=np.uint32))
            b.tail_mask_padd = padd
            t.update(b)
            losses.append(float(np.asarray(t._last_loss)))
        final = {"params": jax.tree.map(np.asarray, t.params),
                 "opt": jax.tree.map(np.asarray, t.opt_state),
                 "buffers": jax.tree.map(np.asarray, t.buffers)}
        return init, losses, final
    finally:
        for k, v in saved.items():
            engine.opts.set(k, v)


def _port_case(net, extra, kw, init, ckpt=None):
    case = dict(net=net, extra=tuple(extra) + (("dp_bucket_mb", "0.001"),),
                init=init, steps=4, shape=kw.get("shape", (3, 16, 16)),
                tail_padd=kw.get("tail_padd", 0))
    if ckpt:
        case["ckpt"] = ckpt
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX package, then through one spawned group
    of four gloo ranks (each case with its mesh); plus the ZeRO case's
    snapshot."""
    out = tmp_path_factory.mktemp("dp")
    jax_res, cases = {}, []
    for cid, net, extra, mesh, kw in CASES:
        jax_res[cid] = _jax_run(net, extra, mesh, kw)
        cases.append(_port_case(
            net, tuple(extra) + (("mesh", mesh),), kw, jax_res[cid][0],
            ckpt=str(out / "zero.ckpt") if cid == "zero" else None))
    port = ranks.run_group(cases, out, 4)
    return {cid: (jax_res[cid], port[i])
            for i, (cid, *_) in enumerate(CASES)}, out


def _assert_params_close(port_params, jax_params, what):
    from cxxnet_tpu_torch.nnet.trainer import flat_tags
    assert sorted(port_params) == sorted(jax_params)
    for pkey, g in port_params.items():
        jg = flat_tags(jax_params[pkey])
        assert sorted(g) == sorted(jg), pkey
        for tag, v in g.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jg[tag], np.float32), rtol=0,
                atol=PARAM_ATOL, err_msg=f"{what}: {pkey}/{tag}")


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_port_mesh_matches_jax_mesh(runs, cid):
    """Losses within 1e-6 relative and parameters within 1e-5 of the JAX
    package's run of the same config on its mesh; buffers (batch_norm's
    moving statistics) within the parameter bound; the replicas agree
    bitwise after every step."""
    (init, jlosses, jfinal), port = runs[0][cid]
    np.testing.assert_allclose(port["losses"], jlosses, rtol=LOSS_RTOL,
                               atol=0, err_msg=cid)
    _assert_params_close(port["state"]["params"], jfinal["params"], cid)
    if jfinal["buffers"]:
        _assert_params_close(port["state"]["buffers"], jfinal["buffers"],
                             cid)
    assert port["drift"] == [0.0] * 4, port["drift"]


def test_zero_and_model_shards_are_the_jax_rules(runs):
    """The leaves ZeRO shards and the leaves the model axis shards are
    the JAX package's (``dp_zero_grads`` / ``dp_model_sharded``)."""
    res = runs[0]
    assert res["zero"][1]["zero"] == [("00-fc1", "wmat")]
    assert res["fullc_gather"][1]["model"] == [("00-fc1", "wmat"),
                                               ("02-fc2", "wmat")]
    assert res["plain"][1]["zero"] == [] == res["plain"][1]["model"]


def test_overlap_cases_ran_the_bucketed_step(runs):
    """The dp_overlap = 1 cases built the bucket plan (not a fallback)
    and the plan has the JAX package's bucket count."""
    res = runs[0]
    for cid in ("plain_overlap", "tail_mask_overlap", "zero_overlap",
                "update_period_step", "update_period_apply",
                "fullc_gather_overlap"):
        assert res[cid][1]["buckets"] and res[cid][1]["buckets"] >= 2, cid


def test_mesh_matches_one_device_at_the_global_batch(runs):
    """data:4 against the port on one device over the same global
    batches, from the same weights: within the same bounds."""
    (init, _, _), port = runs[0]["plain"]
    one = ranks.train_case(_port_case(CONV_NET, (), {}, init), "cpu")
    np.testing.assert_allclose(port["losses"], one["losses"],
                               rtol=LOSS_RTOL, atol=0)
    for pkey, g in one["state"]["params"].items():
        for tag, v in g.items():
            np.testing.assert_allclose(
                port["state"]["params"][pkey][tag].numpy(), v.numpy(),
                rtol=0, atol=PARAM_ATOL)


def test_zero_snapshot_is_the_jax_packages_checkpoint(runs):
    """The ZeRO data:4 run's ``.ckpt`` holds the logical arrays: the JAX
    package's trainer loads it onto its own ZeRO mesh and holds rank 0's
    parameters and optimizer state, bitwise."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    res, out = runs
    state = res["zero"][1]["state"]
    jt = JTrainer()
    for k, v in (("batch_size", "16"), ("dev", "cpu:0-3"),
                 ("mesh", "data:4"), ("shard_opt_state", "1"),
                 ("silent", "1")):
        jt.set_param(k, v)
    jt.load_model(str(out / "zero.ckpt"))
    for pkey, g in state["params"].items():
        for tag, v in g.items():
            np.testing.assert_array_equal(
                np.asarray(jt.params[pkey][tag]), v.numpy())
    for pkey, g in state["opt"].items():
        for tag, st in g.items():
            for name, v in st.items():
                np.testing.assert_array_equal(
                    np.asarray(jt.opt_state[pkey][tag][name]), v.numpy(),
                    err_msg=f"{pkey}/{tag}/{name}")


# ------------------------------------------------------- gates, one device

GATES = [
    ("data_axis", "data:1", (), "mesh has no data axis wider than 1"),
    ("remat", "data:2", (("remat", "2"),),
     "remat/batch_split paths schedule their own backward"),
    ("batch_split", "data:2", (("batch_split", "2"),),
     "remat/batch_split paths schedule their own backward"),
    ("buffers", "data:2", (), "stateful layers (running buffers, e.g. "
     "batch_norm) don't thread through the sliced vjp"),
    ("sibling_fuse", "data:2", (("conv_sibling_fuse", "1"),),
     "conv_sibling_fuse/concat_virtual rewrite the forward graph"),
    ("eval_node", "data:2", (("metric[label,1]", "error"),),
     "a train-metric eval node sits before the loss-tail frontier"),
]


@pytest.mark.parametrize("gid,mesh,extra,words", GATES,
                         ids=[g[0] for g in GATES])
def test_dp_overlap_fallback_warns_once(capsys, gid, mesh, extra, words):
    """Each fallback gate of dp_overlap = 1 keeps the implicit step and
    warns once, in the JAX package's words (checked on the trainer
    ``task = check`` builds: a virtual mesh on meta)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = BN_NET if gid == "buffers" else CONV_NET
    t = NetTrainer()
    for k, v in parse_config_string(net):
        t.set_param(k, v)
    for k, v in (("batch_size", "16"), ("dev", "cpu"), ("mesh", mesh),
                 ("dp_overlap", "1")) + tuple(extra):
        t.set_param(k, v)
    t.init_model(torch.device("meta"))
    capsys.readouterr()
    assert not t._dp_overlap_active()
    assert not t._dp_overlap_active()
    err = capsys.readouterr().err
    line = f"dp_overlap = 1 ignored: {words}; using the implicit-psum step"
    assert err.count(line) == 1, err


def test_one_device_has_no_group_hook_or_collective(capsys):
    """At one device the step is the single-device step: no process
    group, no mesh, no collective launched; dp_overlap = 1 warns that
    there is nothing to reduce, as the JAX package does."""
    import torch.distributed as dist
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    before = dict(meshlib.counts)
    t = ranks.port_trainer(CONV_NET, 16, "cpu", (("dp_overlap", "1"),))
    (data, label, _), = ranks.batches(1)
    from cxxnet_tpu_torch.io.data import DataBatch
    t.update(DataBatch(data=data, label=label,
                       index=np.arange(16, dtype=np.uint32)))
    assert np.isfinite(float(t.last_loss))
    assert t.mesh is None and not dist.is_initialized()
    assert meshlib.counts == before
    assert all(p.grad is None for g in t.params.values()
               for p in g.values())
    assert "dp_overlap = 1 ignored: mesh has no data axis wider than 1" \
        in capsys.readouterr().err

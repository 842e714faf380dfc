"""Rank bodies of the port's data-parallel tests (tests/test_torch_dp.py,
tests/test_torch_overlap.py, tests/test_torch_pipeline.py): gloo ranks
spawned on the CPU by ``cxxnet_tpu_torch.parallel.mesh.spawn``, one
intra-op thread a rank.
This module imports torch and the port only (never JAX): every spawned
rank imports it.

:func:`run_group` spawns one group that trains every case of a list
(each case a fresh trainer over the same seeded numpy batches, its
initial weights given as the JAX package's arrays or made from the
port's seed) and leaves, per case, rank 0's per-step losses and the
logical state (params, optimizer state, buffers) in a ``.pt`` file, with
every rank's ``check_weight_consistency`` after each step.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: a spawned group fails the test instead of hanging the suite
JOIN_TIMEOUT_SEC = 120.0


def batches(n: int, batch: int = 16, shape=(3, 16, 16), classes: int = 4,
            tail_padd: int = 0):
    """``tests/test_overlap.py``'s seeded batches as ``(data, label,
    tail_padd)`` numpy triples."""
    rnd = np.random.RandomState(0)
    out = []
    for i in range(n):
        data = rnd.rand(batch, *shape).astype(np.float32)
        label = rnd.randint(0, classes, (batch, 1)).astype(np.float32)
        out.append((data, label, tail_padd if i == n - 1 else 0))
    return out


def port_trainer(net: str, batch: int, dev: str, extra=()):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(net):
        t.set_param(k, v)
    t.set_param("batch_size", str(batch))
    t.set_param("dev", dev)
    for k, v in extra:
        t.set_param(k, v)
    t.init_model()
    return t


def _host(tree):
    return {k: _host(v) if isinstance(v, dict)
            else v.detach().float().cpu().clone() for k, v in tree.items()}


def logical_state(t) -> Dict:
    t._ensure_opt_state()
    return {"params": _host(t._logical_params()),
            "opt": _host(t._logical_opt()),
            "buffers": _host(t.buffers)}


def train_case(case: Dict, dev: str) -> Dict:
    """One case on this rank: ``case`` holds ``net``, ``extra`` pairs,
    ``batch``, ``shape``, ``steps``, ``tail_padd`` and optionally
    ``init`` (the JAX package's params / buffers as numpy trees),
    ``data`` (the batches themselves, ``(data, label, tail_padd)``
    triples, instead of the seeded image batches) and ``eval`` (a batch
    whose final node is read by the eval forward before the first
    step).  On a pipe mesh the result holds the schedule's statistics
    of each step (``pipe_stats``)."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import params_from_jax
    t = port_trainer(case["net"], case.get("batch", 16), dev,
                     case.get("extra", ()))
    if case.get("init") is not None:
        t.set_state(*params_from_jax(*case["init"]))
    evals = None
    if case.get("eval") is not None:
        x = torch.from_numpy(case["eval"]).to(t.device)
        if t._data_split():
            x = x[torch.as_tensor(t._rows(x.shape[0]))]
        evals = torch.from_numpy(t.forward_eval(x, [t.net.final_node])[0])
    t.start_round(1)
    losses, drift, pipe_stats = [], [], []
    for data, label, padd in case.get("data") or batches(
            case.get("steps", 4), case.get("batch", 16),
            case.get("shape", (3, 16, 16)),
            tail_padd=case.get("tail_padd", 0)):
        b = DataBatch(data=data, label=label,
                      index=np.arange(data.shape[0], dtype=np.uint32))
        b.tail_mask_padd = padd
        t.update(b)
        losses.append(float(t.last_loss))
        pipe_stats.append(dict(t.pipe_stats))
        drift.append(t.check_weight_consistency())
    out = {"losses": losses, "drift": drift, "state": logical_state(t),
           "pipe_stats": pipe_stats, "eval": evals,
           "zero": sorted(t.zero_leaves), "model": sorted(t.model_sharded),
           # what this rank holds of each expert-sharded leaf: (axis,
           # logical rows, the parameter's shape, its optimizer state's)
           "expert": {f"{k}/{tag}": (axis, rows,
                                     tuple(t.params[k][tag].shape),
                                     {n: tuple(a.shape) for n, a in
                                      t.opt_state[k][tag].items()})
                      for (k, tag), (axis, rows)
                      in t.expert_sharded.items()},
           "buckets": None if t._dp_plan_state is None
           or t._dp_plan_state[0] is None
           else len(t._dp_plan_state[0].stages)}
    if case.get("ckpt"):
        from cxxnet_tpu_torch import ckpt
        shards, meta = t.checkpoint_payload()
        if t.mesh is None or t.mesh.rank == 0:
            ckpt.write_snapshot(case["ckpt"], shards, meta)
    return out


def _group_body(rank: int, cases: List[Dict], out_dir: str,
                dev: str) -> None:
    torch.set_num_threads(1)
    from cxxnet_tpu_torch.monitor import log as mlog
    if rank:
        mlog.mute()
    for i, case in enumerate(cases):
        res = train_case(case, dev)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"case{i}.pt"))
        if case.get("all_ranks"):
            torch.save(res, os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def run_group(cases: List[Dict], out_dir: str, nprocs: int) -> List[Dict]:
    """Train every case on ``nprocs`` gloo ranks (``dev = cpu:0-N``) in
    one spawned group; rank 0's results, case by case (a case marked
    ``all_ranks`` also leaves every rank's, ``rank_results``)."""
    from cxxnet_tpu_torch.parallel import mesh
    mesh.spawn(_group_body, nprocs,
               (cases, str(out_dir), f"cpu:0-{nprocs - 1}"),
               timeout_sec=JOIN_TIMEOUT_SEC)
    return [torch.load(os.path.join(out_dir, f"case{i}.pt"))
            for i in range(len(cases))]


def rank_results(out_dir: str, i: int, nprocs: int) -> List[Dict]:
    """Every rank's result of case ``i`` of an ``all_ranks`` case."""
    return [torch.load(os.path.join(out_dir, f"case{i}_rank{r}.pt"))
            for r in range(nprocs)]


# ----------------------------------------------------- pipeline toy stages
#: the toy pipeline's sizes: stages, microbatches, rows and width
TOY_S, TOY_M, TOY_MB, TOY_D = 2, 4, 3, 4


def toy_inputs():
    """Seeded numpy inputs of the toy pipelines: stacked per-stage
    weights and biases, microbatches, labels, the hetero stages'
    weights."""
    rnd = np.random.RandomState(11)
    return dict(
        w=(rnd.randn(TOY_S, TOY_D, TOY_D) * 0.5).astype(np.float32),
        b=(rnd.randn(TOY_S, TOY_D) * 0.1).astype(np.float32),
        x=rnd.randn(TOY_M, TOY_MB, TOY_D).astype(np.float32),
        lab=rnd.randn(TOY_M, TOY_MB, TOY_D).astype(np.float32),
        w0=(rnd.randn(TOY_D, 6) * 0.5).astype(np.float32),
        w1=(rnd.randn(6, 2) * 0.5).astype(np.float32))


def _toy_body(rank: int, out_dir: str) -> None:
    """The toy stages through every entry point of
    ``parallel/pipeline.py`` on a ``pipe:2`` mesh; rank 0 saves."""
    torch.set_num_threads(1)
    from cxxnet_tpu_torch.parallel import mesh as meshlib, pipeline
    m = meshlib.build_mesh(meshlib.MeshSpec({"pipe": TOY_S}),
                           torch.device("cpu"))
    s = m.axis_index("pipe")
    inp = {k: torch.from_numpy(v) for k, v in toy_inputs().items()}
    mine = {"w": inp["w"][s], "b": inp["b"][s]}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out = {"apply": pipeline.pipeline_apply(stage_fn, mine, inp["x"],
                                            mesh=m)}
    for sched in ("1f1b", "gpipe"):
        loss, grads = pipeline.pipeline_1f1b(
            stage_fn, lambda y, lab: ((y - lab) ** 2).sum(), mine,
            inp["x"], inp["lab"], mesh=m, schedule=sched)
        out[f"1f1b_{sched}"] = (loss, grads)
    new, loss = pipeline.pipeline_train_step(
        stage_fn, lambda y, lab: ((y - lab) ** 2).mean(), mine, inp["x"],
        inp["lab"], mesh=m, lr=0.1)
    out["train_step"] = (new, loss)
    w0 = inp["w0"].clone().requires_grad_()
    w1 = inp["w1"].clone().requires_grad_()

    def st0(acts, aux, mm):
        h = torch.tanh(acts[0] @ w0)
        return (h,), aux + 0.01 * (h ** 2).sum()

    def st1(acts, aux, mm):
        return (acts[0] @ w1,), aux

    outs, auxs = pipeline.pipeline_apply_hetero([st0, st1], inp["x"],
                                                mesh=m)
    out["hetero"] = (outs[0], auxs)
    loss, grads, res = pipeline.pipeline_1f1b_hetero(
        [st0, st1], lambda acts, aux, mm: aux + (acts[0] ** 2).sum(),
        [w0, w1], inp["x"], mesh=m)
    out["1f1b_hetero"] = (loss, grads)
    torch.save(out, os.path.join(out_dir, f"toys{rank}.pt"))


def run_toys(out_dir: str) -> List[Dict]:
    """Each rank's toy results (:func:`_toy_body`), by pipe index."""
    from cxxnet_tpu_torch.parallel import mesh
    mesh.spawn(_toy_body, TOY_S, (str(out_dir),),
               timeout_sec=JOIN_TIMEOUT_SEC)
    return [torch.load(os.path.join(out_dir, f"toys{r}.pt"))
            for r in range(TOY_S)]

"""Rank bodies of the port's data-parallel tests (tests/test_torch_dp.py,
tests/test_torch_overlap.py): gloo ranks spawned on the CPU by
``cxxnet_tpu_torch.parallel.mesh.spawn``, one intra-op thread a rank.
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
    ``init`` (the JAX package's params / buffers as numpy trees) and
    ``data`` (the batches themselves, ``(data, label, tail_padd)``
    triples, instead of the seeded image batches)."""
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import params_from_jax
    t = port_trainer(case["net"], case.get("batch", 16), dev,
                     case.get("extra", ()))
    if case.get("init") is not None:
        t.set_state(*params_from_jax(*case["init"]))
    t.start_round(1)
    losses, drift = [], []
    for data, label, padd in case.get("data") or batches(
            case.get("steps", 4), case.get("batch", 16),
            case.get("shape", (3, 16, 16)),
            tail_padd=case.get("tail_padd", 0)):
        b = DataBatch(data=data, label=label,
                      index=np.arange(data.shape[0], dtype=np.uint32))
        b.tail_mask_padd = padd
        t.update(b)
        losses.append(float(t.last_loss))
        drift.append(t.check_weight_consistency())
    out = {"losses": losses, "drift": drift, "state": logical_state(t),
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


def run_group(cases: List[Dict], out_dir: str, nprocs: int) -> List[Dict]:
    """Train every case on ``nprocs`` gloo ranks (``dev = cpu:0-N``) in
    one spawned group; rank 0's results, case by case."""
    from cxxnet_tpu_torch.parallel import mesh
    mesh.spawn(_group_body, nprocs,
               (cases, str(out_dir), f"cpu:0-{nprocs - 1}"),
               timeout_sec=JOIN_TIMEOUT_SEC)
    return [torch.load(os.path.join(out_dir, f"case{i}.pt"))
            for i in range(len(cases))]

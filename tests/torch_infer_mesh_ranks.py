"""Rank bodies of tests/test_torch_infer_mesh.py: gloo ranks spawned on
the CPU by ``cxxnet_tpu_torch.parallel.mesh.spawn``, one intra-op thread
a rank, each running the port's CLI (``LearnTask().run``) inside the
group as a rank that the CLI spawned would.
This module imports torch and the port only (never JAX): every spawned
rank imports it.

:func:`run_group` spawns one group of four ranks.  They run the parts
of world 4 together; then the group splits into two groups of two
(ranks 0-1 and 2-3, each a fresh process group), which run their own
lists of parts side by side.  A part is a CLI ``argv`` run on every
rank of its group, or ``("raises", argv)``: a run that every rank must
refuse with a ``ValueError`` before any collective (its message kept),
or ``("wrapper", spec)``: the wrapper API in the group
(:func:`wrapper_part`).  Each rank leaves a JSON file of its results.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: a spawned group fails the test instead of hanging the suite
JOIN_TIMEOUT_SEC = 240.0


def run_part(part):
    """One part on this rank; its result (JSON-able)."""
    from cxxnet_tpu_torch.main import LearnTask
    kind, arg = part if isinstance(part, tuple) else ("run", part)
    if kind == "run":
        task = LearnTask()
        rc = task.run(list(arg))
        return {"rc": rc, "mesh": None if task.net.mesh is None
                else dict(task.net.mesh.axes)}
    if kind == "raises":
        try:
            LearnTask().run(list(arg))
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    if kind == "wrapper":
        return wrapper_part(arg)
    raise ValueError(f"unknown part kind {kind!r}")


def wrapper_part(spec) -> dict:
    """The wrapper API in this group: a ``Net`` of ``spec["dev"]`` loads
    ``spec["model"]``, predicts and extracts ``spec["rows"]`` (an .npy
    file; every rank returns every row), serves the rows through
    ``enable_serving`` (rank 0: the raw rows and the predicted classes;
    the other ranks follow until rank 0 disables it) and takes one
    ``update`` on rows and labels; returns the arrays' lists and the
    weights of ``spec["layer"]`` after the update."""
    from cxxnet_tpu_torch.wrapper.api import Net
    rows = np.load(spec["rows"])
    labels = np.load(spec["labels"])
    net = Net(dev=spec["dev"], cfg=spec["cfg"])
    net.load_model(spec["model"])
    out = {"pred": net.predict(rows).tolist(),
           "extract": net.extract(rows, spec["node"]).tolist()}
    net.enable_serving(spec["serve_cfg"])
    if net._serve is not None:
        out["serve"] = net._serve.predict(rows).tolist()
        out["serve_pred"] = net.predict(rows).tolist()
        net.disable_serving()
    net.start_round(1)
    net.update(rows, labels)
    out["weight"] = net.get_weight(spec["layer"], "wmat").tolist()
    out["rank"] = int(torch.distributed.get_rank())
    return out


def _regroup(rank: int, root: str) -> None:
    """Leave the world of four for a group of two: ranks 0-1 and 2-3,
    each over its own file store."""
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    sub = rank // 2
    store = dist.FileStore(os.path.join(root, f"store2_{sub}"), 2)
    dist.init_process_group("gloo", store=store, rank=rank % 2,
                            world_size=2,
                            timeout=datetime.timedelta(
                                seconds=JOIN_TIMEOUT_SEC))


def _group_rank(rank: int, root: str, parts4, parts2) -> None:
    torch.set_num_threads(1)
    res = {"world4": {}, "world2": {}}
    try:
        for label, part in parts4:
            res["world4"][label] = run_part(part)
        _regroup(rank, root)
        for label, part in parts2[rank // 2]:
            res["world2"][label] = run_part(part)
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)


def run_group(root: str, parts4, parts2) -> list:
    """Spawn the four ranks over ``parts4`` (every rank) and then
    ``parts2`` (a list per group of two); returns each rank's results."""
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    try:
        meshlib.spawn(_group_rank, 4, (root, parts4, parts2),
                      timeout_sec=JOIN_TIMEOUT_SEC)
    except BaseException:
        for r in range(4):
            p = os.path.join(root, f"rank{r}.json")
            if os.path.exists(p):
                err = json.load(open(p)).get("error")
                if err:
                    sys.stderr.write(f"rank {r}:\n{err}\n")
        raise
    return [json.load(open(os.path.join(root, f"rank{r}.json")))
            for r in range(4)]

"""The ``.model`` snapshot format, read and written exactly as the JAX
package does (``cxxnet_tpu/utils/serializer.py``): one numpy ``.npz``
holding a JSON header (format version, net structure, epoch, dtypes,
extra) plus every tensor under a flattened ``group/key`` name
(``params/<NN-name>/<tag>``).  bfloat16 tensors are stored as exact
float32 and their dtype recorded in the header's ``dtypes`` map, so a
snapshot written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def _to_numpy(v, key: str, dtypes: Dict[str, str]) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
            return v.detach().float().cpu().numpy()
        return v.detach().cpu().numpy()
    a = np.asarray(v)
    if a.dtype.kind not in "fiub":
        # extension float types (bfloat16) are stored as exact float32
        dtypes[key] = a.dtype.name
        a = a.astype(np.float32)
    return a


def _flatten(tree: Dict, prefix: str, dtypes: Dict[str, str]
             ) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/", dtypes))
        else:
            out[key] = _to_numpy(v, key, dtypes)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def flatten_tree(tree: Dict, dtypes: Dict[str, str]) -> Dict[str, np.ndarray]:
    """Nested tree -> ``{"a/b/c": np.ndarray}`` with bfloat16 widened to
    exact float32 and recorded in ``dtypes`` (the checkpoint shards'
    form, as ``save_model`` stores its arrays).  A float32 CPU tensor
    comes back as a view of its storage: a caller that hands the arrays
    to another thread passes independent copies in."""
    return _flatten(tree, "", dtypes)


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_tree`; widened leaves stay float32 and
    are named in the ``dtypes`` map their writer recorded."""
    return _unflatten(flat)


def atomic_write(path: str, write_fn) -> None:
    """Write via ``<path>.tmp`` + fsync + ``os.replace`` + directory
    fsync: readers see the old complete file or the new one."""
    tmp = path + ".tmp"
    try:
        # disclint: ok(atomic-write) — the tmp half of the protocol itself
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_model(path: str, *, net_structure: dict, epoch: int,
               params: Dict, buffers: Dict, opt_state: Dict = None,
               extra_meta: Dict = None) -> None:
    """Write a ``.model``; ``opt_state`` (the updater's per-tensor state,
    ``opt/<key>/<tag>/<name>``) is optional, as in the JAX package."""
    dtypes: Dict[str, str] = {}
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten({"params": params}, "", dtypes))
    arrays.update(_flatten({"buffers": buffers}, "", dtypes))
    if opt_state is not None:
        arrays.update(_flatten({"opt": opt_state}, "", dtypes))
    header = {"format_version": FORMAT_VERSION, "net": net_structure,
              "epoch": int(epoch), "has_opt_state": opt_state is not None,
              "dtypes": dtypes, "extra": extra_meta or {}}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    atomic_write(path, lambda f: np.savez(f, **arrays))


def load_model(path: str) -> Tuple[dict, Dict, Dict, Dict]:
    """Return ``(header, params, buffers, opt_state or None)`` as nested
    dicts of numpy arrays; bfloat16 leaves come back as their stored
    float32, named in ``header["dtypes"]`` under their flattened key."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"]).decode("utf-8"))
        flat = {k: z[k] for k in z.files if k != "__header__"}
    tree = _unflatten(flat)
    opt = tree.get("opt") if header.get("has_opt_state") else None
    return header, tree.get("params", {}), tree.get("buffers", {}), opt

"""Checkpoint snapshots: atomic ``NNNN.ckpt`` directories with a
manifest for exact resume (the JAX package's ``ckpt`` format, read and
written the same way, so a snapshot of either package loads in the
other).

A **snapshot** is a directory ``<model_dir>/NNNN.ckpt/`` written with a
manifest-last protocol:

1. each shard (``params`` / ``buffers`` / ``opt`` / ``acc``) is written
   to ``<shard>.npz.tmp`` and ``os.replace``d to ``<shard>.npz``;
2. ``MANIFEST.json`` is written to a temp name, fsynced, and
   ``os.replace``d into place **last**.

The manifest is the commit marker: a snapshot without one, or whose
shard files fail their recorded size / crc32, is partial or corrupt and
``continue = 1`` skips it (the previous snapshot wins).  A kill at any
byte of the write therefore never loses the previous good snapshot and
never yields a loadable half-written one.

The manifest also carries what exact resume needs beyond the arrays:
the epoch / round counters, the trainer's rng state (``train_state``)
and the train iterator chain's state (``iter_state``).  Arrays are
stored as full host arrays, bfloat16 widened to exact float32 with the
original dtypes recorded under ``dtypes``.

:mod:`.writer` writes snapshots off the training thread.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..analysis.schema import K
from ..utils.serializer import atomic_write

FORMAT_VERSION = 1
MANIFEST = "MANIFEST.json"

#: checkpoint / rollback keys the task driver consumes
#: (``main.LearnTask.set_param``), declared next to their subsystem and
#: appended to ``main.TASK_KEYS``
CKPT_KEYS = (
    K("ckpt_async", "int", lo=0, hi=1,
      help="write snapshots off the training thread (atomic .ckpt dirs)"),
    K("ckpt_keep", "int", lo=1,
      help="retention: keep the newest N .ckpt snapshots"),
    K("rollback", "int", lo=0,
      help="on TrainingDiverged: restore the last good snapshot, reseed "
           "the rng stream, retry up to N times"),
    K("save_opt", "int", lo=0, hi=1,
      help="include optimizer state in snapshots (default 1: exact "
           "resume)"),
    K("ckpt_iter_state", "int", lo=0, hi=1,
      help="carry the train-iterator chain state in snapshots (default "
           "1: cross-round iterator rng/cache state resumes exactly)"),
)


def snapshot_path(model_dir: str, counter: int) -> str:
    return os.path.join(model_dir, f"{counter:04d}.ckpt")


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def write_snapshot(path: str, shards: Dict[str, Dict[str, np.ndarray]],
                   meta: dict, fault_hook=None, tracer=None) -> dict:
    """Write one snapshot directory atomically (manifest last).

    ``shards`` maps shard name -> flat ``{key: np.ndarray}`` (the
    serializer's :func:`~..utils.serializer.flatten_tree` form).
    ``fault_hook(stage)`` is the crash-injection point for tests, called
    after each shard (``"shard:<name>"``) and before the manifest
    (``"manifest"``): raising there leaves exactly the partial state a
    kill at that byte would.  ``tracer`` (a span tracer) times each
    shard (``ckpt_shard``) and the manifest commit (``ckpt_manifest``).
    Returns ``{"bytes": total, "shards": n}``.
    """
    if tracer is None:
        from ..monitor import spans
        tracer = spans.NULL
    os.makedirs(path, exist_ok=True)
    # rewriting a committed snapshot: drop the manifest FIRST, so a kill
    # mid-rewrite leaves an uncommitted directory, not a manifest that
    # points at shards of two ages
    mpath = os.path.join(path, MANIFEST)
    if os.path.exists(mpath):
        os.remove(mpath)
    shard_meta: Dict[str, dict] = {}
    total = 0
    for name, arrays in shards.items():
        fpath = os.path.join(path, f"{name}.npz")
        with tracer.span("ckpt_shard", shard=name):
            atomic_write(fpath, lambda f, a=arrays: np.savez(f, **a))
            size = os.path.getsize(fpath)
            # a read-back of the committed file: np.savez seeks back to
            # rewrite zip headers, so a checksum taken while writing
            # would not be of the bytes on disk
            shard_meta[name] = {"file": f"{name}.npz", "bytes": size,
                                "crc32": _crc32(fpath)}
        total += size
        if fault_hook is not None:
            fault_hook(f"shard:{name}")
    if fault_hook is not None:
        fault_hook("manifest")
    manifest = {"format_version": FORMAT_VERSION, "shards": shard_meta}
    manifest.update(meta)
    with tracer.span("ckpt_manifest"):
        atomic_write(mpath, lambda f: f.write(
            json.dumps(manifest, sort_keys=True).encode("utf-8")))
    return {"bytes": total, "shards": len(shard_meta)}


def _read_manifest(path: str) -> Optional[dict]:
    """``path``'s manifest when present, well-formed and of this format
    version; None otherwise."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isdir(path) or not os.path.exists(mpath):
        return None
    try:
        with open(mpath, "rb") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if manifest.get("format_version") != FORMAT_VERSION:
        return None
    return manifest


def validate_snapshot(path: str) -> Optional[dict]:
    """The manifest when ``path`` is a complete, uncorrupted snapshot;
    None otherwise (missing or torn manifest, missing shard, size or crc
    mismatch: the states a kill leaves)."""
    manifest = _read_manifest(path)
    if manifest is None:
        return None
    for name, sm in (manifest.get("shards") or {}).items():
        fpath = os.path.join(path, sm.get("file", f"{name}.npz"))
        if not os.path.exists(fpath):
            return None
        if os.path.getsize(fpath) != sm.get("bytes"):
            return None
        if _crc32(fpath) != sm.get("crc32"):
            return None
    return manifest


def load_snapshot(path: str, assume_valid: bool = False
                  ) -> Tuple[dict, Dict[str, Dict[str, np.ndarray]]]:
    """(manifest, shard name -> flat arrays) of a complete snapshot;
    raises ValueError on a partial or corrupt one.  ``assume_valid``
    skips the crc re-read for a caller that has just run
    :func:`validate_snapshot` on ``path`` (the manifest must still parse)."""
    manifest = _read_manifest(path) if assume_valid \
        else validate_snapshot(path)
    if manifest is None:
        raise ValueError(
            f"{path}: not a complete checkpoint snapshot (missing/torn "
            "manifest or shard checksum mismatch)")
    shards: Dict[str, Dict[str, np.ndarray]] = {}
    for name, sm in manifest["shards"].items():
        with np.load(os.path.join(path, sm["file"]),
                     allow_pickle=False) as z:
            shards[name] = {k: z[k] for k in z.files}
    return manifest, shards


def list_snapshots(model_dir: str) -> List[Tuple[int, str]]:
    """Every snapshot candidate in ``model_dir`` (committed or partial
    ``NNNN.ckpt`` directories and ``NNNN.model`` files) as ``(counter,
    path)``, ascending; at one counter the ``.ckpt`` comes last, so a
    newest-first scan prefers it."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(model_dir)
    except OSError:
        return out
    for n in names:
        stem, _, ext = n.rpartition(".")
        if ext not in ("ckpt", "model") or not stem.isdigit():
            continue
        out.append((int(stem), os.path.join(model_dir, n)))
    out.sort(key=lambda t: (t[0], t[1].endswith(".ckpt")))
    return out


def prune_snapshots(model_dir: str, keep: int) -> int:
    """Retention: delete all but the newest ``keep`` committed ``.ckpt``
    snapshots, and every partial one older than the newest committed
    (debris of a kill); ``.model`` files are left alone.  Returns the
    number of directories removed."""
    keep = max(int(keep), 1)
    dirs = [(c, p) for c, p in list_snapshots(model_dir)
            if p.endswith(".ckpt")]
    committed = [(c, p) for c, p in dirs
                 if os.path.exists(os.path.join(p, MANIFEST))]
    drop = {p for _, p in committed[:-keep]}
    if committed:
        newest = committed[-1][0]
        drop |= {p for c, p in dirs
                 if c < newest
                 and not os.path.exists(os.path.join(p, MANIFEST))}
    for p in drop:
        shutil.rmtree(p, ignore_errors=True)
    return len(drop)

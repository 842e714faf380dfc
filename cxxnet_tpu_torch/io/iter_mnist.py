"""MNIST idx-ubyte iterator (the JAX package's ``io/iter_mnist.py``;
reference ``src/io/iter_mnist-inl.hpp``): reads the gzip idx files,
scales pixels by 1/256, optionally shuffles in memory with a fixed seed,
and emits fixed-size batches, (n, 1, 1, 784) under ``input_flat = 1``
(the default) or (n, 1, 28, 28).  The tail beyond the last full batch is
padded with replicas of the last instance that train with zero loss
(``tail_mask_padd``); ``round_batch = 1`` wraps real instances from the
epoch's start instead.  Either way ``num_batch_padd`` keeps the padding
out of evaluation.  :meth:`MNISTIterator.state` is the cursor, as the
reference's, for checkpoint resume."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from ..analysis.schema import K
from ..monitor import log as mlog
from .data import DataBatch, IIterator

_RAND_MAGIC = 27  # the reference's fixed shuffle seed of this iterator


class MNISTIterator(IIterator):
    config_keys = (
        K("silent", "int", lo=0, hi=1), K("batch_size", "int", lo=1),
        K("input_flat", "int", lo=0, hi=1),
        K("shuffle", "int", lo=0, hi=1), K("index_offset", "int"),
        K("path_img", "path"), K("path_label", "path"),
        K("round_batch", "int", lo=0, hi=1),
        K("seed_data", "int"),
    )

    def __init__(self):
        self.silent = 0
        self.batch_size = 0
        self.input_flat = 1
        self.shuffle = 0
        self.index_offset = 0
        self.path_img = ""
        self.path_label = ""
        self.round_batch = 0
        self.seed_data = 0
        self.loc = 0

    def set_param(self, name, val):
        if name in ("silent", "batch_size", "input_flat", "shuffle",
                    "index_offset", "round_batch", "seed_data"):
            setattr(self, name, int(val))
        elif name in ("path_img", "path_label"):
            setattr(self, name, val)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") \
            else open(path, "rb")

    def init(self):
        with self._open(self.path_img) as f:
            _, n, rows, cols = struct.unpack(">iiii", f.read(16))
            self.img = np.frombuffer(f.read(n * rows * cols), np.uint8) \
                .reshape(n, rows, cols).astype(np.float32) * (1.0 / 256.0)
        with self._open(self.path_label) as f:
            _, n_lab = struct.unpack(">ii", f.read(8))
            self.labels = np.frombuffer(f.read(n_lab), np.uint8) \
                .astype(np.float32)
        self.inst = np.arange(len(self.labels), dtype=np.uint32) \
            + self.index_offset
        if self.shuffle:
            order = np.random.RandomState(
                _RAND_MAGIC + self.seed_data).permutation(len(self.labels))
            self.img = self.img[order]
            self.labels = self.labels[order]
            self.inst = self.inst[order]
        assert self.batch_size > 0, "mnist: batch_size must be set"
        if not self.silent:
            mlog.info(f"MNISTIterator: load {len(self.img)} images, "
                      f"shuffle={self.shuffle}, input_flat="
                      f"{self.input_flat}")

    def before_first(self):
        self.loc = 0

    def state(self):
        # the shuffle is fixed at init, so the cursor is the whole state
        return {"loc": int(self.loc)}

    def set_state(self, st):
        self.loc = int(st.get("loc", 0))

    def _view(self, idx: np.ndarray) -> np.ndarray:
        d = self.img[idx]
        if self.input_flat:
            return d.reshape(len(idx), 1, 1, -1)
        return d.reshape(len(idx), 1, d.shape[1], d.shape[2])

    def _batch(self, idx, n_padd=0, mask_padd=0):
        return DataBatch(data=self._view(idx),
                         label=self.labels[idx].reshape(len(idx), 1),
                         index=self.inst[idx], num_batch_padd=n_padd,
                         tail_mask_padd=mask_padd)

    def next(self):
        n, bs = len(self.labels), self.batch_size
        if self.loc + bs <= n:
            idx = np.arange(self.loc, self.loc + bs)
            self.loc += bs
            return self._batch(idx)
        if self.loc >= n:
            return None
        remain = n - self.loc
        fill = (np.arange(0, bs - remain) if self.round_batch
                else np.full(bs - remain, n - 1))
        idx = np.concatenate([np.arange(self.loc, n), fill])
        self.loc = n
        return self._batch(idx, bs - remain,
                           0 if self.round_batch else bs - remain)

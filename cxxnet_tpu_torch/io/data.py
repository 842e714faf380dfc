"""Data iterator interfaces and batch types.

Reference: ``src/io/data.h`` — ``IIterator<DType>`` {Init, BeforeFirst, Next,
Value}, ``DataInst`` (label, data, index) and ``DataBatch`` with the
``num_batch_padd`` padding protocol (:85-87) and ``extra_data`` side inputs
(:93-94).  Python iterators here feed numpy arrays; device transfer happens
in the trainer (single H2D per step, like the reference's single
``Copy(nodes[0], hostBatch)`` at neural_net-inl.hpp:112).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class DataInst:
    """One instance (data.h:41-56)."""

    label: np.ndarray  # (label_width,)
    data: np.ndarray   # (c, y, x)
    index: int


@dataclasses.dataclass
class DataBatch:
    """One mini-batch (data.h:79-110)."""

    data: np.ndarray                 # (n, c, y, x)
    label: np.ndarray                # (n, label_width)
    index: np.ndarray                # (n,) instance ids
    # number of trailing instances that are wrap-around padding; they are
    # trained on (they're real wrapped instances) but excluded from eval
    num_batch_padd: int = 0
    # number of trailing instances that are *replica* padding of a short
    # tail batch (round_batch=0): masked out of training losses AND eval.
    # Always <= num_batch_padd.  The reference instead re-plumbs node
    # shapes (AdjustBatchSize, neural_net-inl.hpp:266-277); padding with a
    # loss mask trains the same real instances without shape polymorphism.
    tail_mask_padd: int = 0
    extra_data: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class IIterator:
    """Iterator interface (data.h:19-39)."""

    #: the keys this stage's ``set_param`` consumes (the declared-key
    #: registry, ``analysis/registry.py``, reads them)
    config_keys: tuple = ()

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self):
        """Return the next element or None at end of epoch."""
        raise NotImplementedError

    def close(self) -> None:
        """Release background resources (threads, pools).  Wrapper iterators
        forward to their base; safe to call more than once."""
        base = getattr(self, "base", None)
        if base is not None:
            base.close()

    # ----------------------------------------------- resumable position
    def state(self) -> dict:
        """JSON-able resume state of this stage + everything beneath it
        (the checkpoint manifest carries it; doc/checkpoint.md).  The
        contract is *positional*, like the reference's round-robin
        restart: stages record where they are (cursor, epoch-done flag,
        augment rng, cache fill) rather than buffered data.  Only valid
        at a quiescent point — a round boundary, after the epoch's
        ``next()`` returned None — so prefetching stages
        (ThreadBufferIterator, DevicePrefetcher) are drained and their
        base's position equals the consumer's.  Stages without
        cross-epoch state just delegate to their base."""
        base = getattr(self, "base", None)
        return {"base": base.state()} if base is not None else {}

    def set_state(self, st: dict) -> None:
        """Restore :meth:`state` (call after ``init()``, before the
        next ``before_first()``)."""
        base = getattr(self, "base", None)
        if base is not None and st and "base" in st:
            base.set_state(st["base"])

    def __iter__(self) -> Iterator:
        self.before_first()
        while True:
            v = self.next()
            if v is None:
                return
            yield v

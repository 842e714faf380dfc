"""Device-side input staging: batches copied to the card ahead of the step
(the JAX package's ``io/device_prefetch.py``).

The reference's ThreadBuffer (``iter_batch_proc-inl.hpp:136-224`` over
``utils/thread_buffer.h``) kept the GPU fed by producing batches on a
thread, but its host-to-device copy still ran inside Update
(``neural_net-inl.hpp:112``).  :class:`DevicePrefetcher` moves the copy
off the step too: a producer thread stages ``depth`` items ahead of the
train loop through the trainer's ``stage_batch``.  On the card a staged
batch is copied from pinned host memory (``pin_memory()``, PyTorch's
caching host allocator) on the prefetcher's own ``torch.cuda.Stream``
with ``non_blocking = True``, under ``torch.cuda.device(dev)`` in the
thread; an event recorded on that stream after the copies travels with
the batch.  The step's stream waits on the event before it reads the
batch, and each staged tensor gets ``record_stream`` on that stream
(:meth:`StagedBatch.handover`), so the allocator never hands its block
to the copy stream while the step still reads it.  The copies are
asynchronous: an item is queued as soon as they are enqueued, and the
caching host allocator keeps a pinned buffer until the copy that reads
it has ended.

With ``depth = 0`` (``prefetch_device = 0``) the same staging runs inline
on the consumer thread, on its current stream, which keeps the copy out
of the step's timer: only the overlap is lost.  On the CPU no stream is
used and a staged batch holds host tensors.

A staged batch carries the host-side label (``label_host``) for the train
metric and ``h2d_sec``, the host wall its staging took (enqueueing
the copies, not their transfer): on the producer thread it overlaps the
step, inline it is critical-path time.  The port
dispatches a batch at a time, so the JAX package's grouped items
(``StagedGroup``, ``StagedEvalGroup`` and their ``StagedMeta``) have no
counterpart: a train item is the list of one window's staged batches,
an eval item one staged batch.

Under ``trace_sample = N`` every Nth item's staging is a
``prefetch_stage`` span (producer side) and every Nth wait of the
consumer on the queue a ``prefetch_wait`` span.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from .data import DataBatch, IIterator


@dataclasses.dataclass
class StagedBatch:
    """One device-resident batch.  ``data`` is the data node's tensor as
    staged (a u8 batch stays u8, normalised in the step; under
    ``input_s2d = 1`` already in space-to-depth form), ``label`` float32,
    ``extra_data`` the side inputs, ``mask`` the tail loss mask when
    ``tail_mask_padd > 0``; on a data mesh the tensors hold this rank's
    rows and ``global_rows`` the batch's.  ``ready`` is the event recorded after the
    copies on the card, None once handed over (and on the CPU).
    ``NetTrainer.update`` / ``predict`` / ``predict_raw`` /
    ``extract_feature`` / ``evaluate`` take it wherever they take a
    ``DataBatch``."""

    data: Any
    label: Any
    label_host: np.ndarray
    index: np.ndarray
    num_batch_padd: int = 0
    tail_mask_padd: int = 0
    extra_data: Tuple[Any, ...] = ()
    mask: Any = None
    h2d_sec: float = 0.0
    ready: Any = None
    # rows of the whole batch when a data-mesh rank staged its rows only
    global_rows: int = 0

    @property
    def batch_size(self) -> int:
        """Rows of the batch (the whole batch's on a data mesh)."""
        return self.global_rows or int(self.data.shape[0])

    def tensors(self) -> list:
        return [t for t in (self.data, self.label, *self.extra_data,
                            self.mask) if t is not None]

    def handover(self) -> "StagedBatch":
        """Make the batch safe to read on the calling thread's current
        stream: that stream waits on the copy stream's event, and every
        tensor is recorded as used by it, so freeing the batch cannot
        recycle its memory under a step still reading it.  Idempotent."""
        if self.ready is not None:
            import torch
            stream = torch.cuda.current_stream(self.data.device)
            stream.wait_event(self.ready)
            for t in self.tensors():
                t.record_stream(stream)
            self.ready = None
        return self


#: a work item: one staged batch (eval and pred), or the list of staged
#: batches of one train window, each dispatched by its own update
StagedItem = Union[StagedBatch, List[StagedBatch]]


def item_h2d_sec(item: StagedItem) -> float:
    """Total staging wall of one work item."""
    if isinstance(item, list):
        return sum(b.h2d_sec for b in item)
    return item.h2d_sec


class ProducerError:
    """Producer-thread exception, queued for re-raise on the consumer
    (shared with :class:`~.iter_proc.ThreadBufferIterator`: a raise on
    the producer must surface in the consumer's next(), never strand it
    on queue.get())."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def generation_put(owner, gen: int, q: "queue.Queue", v,
                   timeout: float = 0.05) -> bool:
    """Bounded put that re-checks ``owner._gen`` so a stale producer
    exits (returns False) instead of blocking forever on an orphaned
    queue.  Shared by every producer-thread stage of this package."""
    while True:
        if owner._gen != gen:
            return False
        try:
            q.put(v, timeout=timeout)
            return True
        except queue.Full:
            continue


class DevicePrefetcher:
    """Pulls host batches from ``base``, stages them through
    ``stager.stage_batch`` and holds a bounded queue of ``depth`` staged
    work items.  A train item is the list of up to ``group_n`` staged
    batches of one window (the port dispatches a batch at a time, so the
    train loop passes 1); ``for_eval`` items are single staged batches.

    Epoch protocol as an iterator's: ``before_first()`` (re)starts a
    producer for one epoch, ``next()`` returns staged items until None
    at the epoch's end.  A generation counter poisons stale producers,
    and ``before_first`` / ``close`` join the previous thread, so one
    thread at a time touches ``base``.  A producer exception is queued
    and re-raised in the consumer, never a silent hang.  ``close()``
    joins the producer but does not close ``base``: its owner does.
    """

    def __init__(self, base: IIterator, stager, *, group_n: int = 1,
                 depth: int = 2, metrics=None, for_eval: bool = False):
        self.base = base
        self.stager = stager
        self.group_n = max(1, int(group_n))
        self.depth = int(depth)
        self.metrics = metrics
        self.for_eval = for_eval
        # sync mode: host-iterator wall behind the last item (the
        # consumer's next() wall minus this is staging time); async mode:
        # queue depth observed at the last get (staged items ready)
        self.last_wait_sec = 0.0
        self.last_depth = 0
        self._iter = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._gen = 0
        self._failed: Optional[BaseException] = None
        self._done = False
        self._stream = None
        # items staged and items waited for, the span sampler's counts
        # racelint: atomic(single-writer int bump: staged on the producer in async mode, on the consumer in sync mode — never both)
        self._span_staged = 0
        self._span_waited = 0

    @property
    def async_(self) -> bool:
        return self.depth > 0

    # ------------------------------------------------------------ staging
    def _stage(self, group: List[DataBatch]) -> StagedItem:
        if self.for_eval:
            return self.stager.stage_batch(group[0])
        return [self.stager.stage_batch(b) for b in group]

    def _epoch_items(self):
        """One epoch's staged work items, each paired with the host
        iterator wall that fed it (the iter-wait split in sync mode; in
        async mode the producer absorbs that wait)."""
        pending: List[DataBatch] = []
        wait = 0.0
        group_n = 1 if self.for_eval else self.group_n
        while True:
            t0 = time.perf_counter()
            b = self.base.next()
            wait += time.perf_counter() - t0
            done = b is None
            if not done:
                pending.append(b)
            if pending and (done or len(pending) >= group_n):
                group, pending = pending, []
                yield self._stage_traced(group), wait
                wait = 0.0
            if done:
                return

    def _stage_traced(self, group: List[DataBatch]) -> StagedItem:
        """:meth:`_stage` in a sampled ``prefetch_stage`` span (the
        producer's staging wall an item)."""
        tracer = getattr(self.metrics, "tracer", None)
        if tracer is not None and tracer.enabled:
            n = self._span_staged
            # racelint: ok(race_rmw) — async and sync staging are mutually exclusive modes; one context ever bumps this
            self._span_staged += 1
            if tracer.sampled(n):
                with tracer.span("prefetch_stage", batches=len(group),
                                 mode="async" if self.async_ else "sync"):
                    return self._stage(group)
        return self._stage(group)

    # ------------------------------------------------------ thread plumbing
    def before_first(self) -> None:
        self._failed = None
        self._done = False
        if not self.async_:
            self.base.before_first()
            self._iter = self._epoch_items()
            return
        self._gen += 1
        if self._thread is not None:
            self._thread.join()  # unblocks via the generation check
        self.base.before_first()
        q = queue.Queue(maxsize=self.depth)
        self._queue = q
        self._thread = threading.Thread(
            target=self._producer, args=(self._gen, q), daemon=True,
            name="cxxnet-device-prefetch")
        self._thread.start()

    def _copy_context(self):
        """The producer thread's device and copy stream on the card (made
        once, on the stager's device), a null context on the CPU."""
        import contextlib
        import torch
        dev = getattr(self.stager, "device", None)
        if dev is None or dev.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _producer(self, gen: int, q: "queue.Queue") -> None:
        try:
            with self._copy_context():
                for item, wait in self._epoch_items():
                    if not generation_put(self, gen, q, (item, wait)):
                        return
            generation_put(self, gen, q, None)
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            generation_put(self, gen, q, ProducerError(e))

    def next(self) -> Optional[StagedItem]:
        """The next staged work item, or None at the epoch's end.
        Re-raises a producer exception (and keeps re-raising until the
        next ``before_first()``: the epoch is dead, never a hang)."""
        if self._failed is not None:
            raise self._failed
        if self._done:
            return None
        if not self.async_:
            assert self._iter is not None, "call before_first() first"
            try:
                item, self.last_wait_sec = next(self._iter)
            except StopIteration:
                self._done = True
                return None
            except BaseException as e:  # latch: sync epochs die like async
                self._failed = e
                raise
            return item
        assert self._queue is not None, "call before_first() first"
        # the consumer's wall blocked on the producer, sampled
        tracer = getattr(self.metrics, "tracer", None)
        tok = None
        if tracer is not None and tracer.enabled:
            n = self._span_waited
            self._span_waited += 1
            if tracer.sampled(n):
                tok = tracer.begin("prefetch_wait")
        v = self._queue.get()
        if tok is not None:
            tracer.end(tok)
        if v is None:
            self._done = True
            return None
        if isinstance(v, ProducerError):
            self._failed = v.exc
            raise v.exc
        item, _ = v
        self.last_depth = self._queue.qsize()
        if self.metrics is not None:
            self.metrics.set_gauge("prefetch_depth", self.last_depth)
        return item

    def __iter__(self):
        self.before_first()
        while True:
            v = self.next()
            if v is None:
                return
            yield v

    def close(self) -> None:
        """Join the producer thread.  The base iterator is not closed:
        its owner (the task's iterator list) does that."""
        self._gen += 1
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._iter = None
        self._queue = None

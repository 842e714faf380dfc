"""Async checkpoint writer: the snapshot is taken on the train thread
and written off it.

The train loop is the producer: it hands a fully host-resident snapshot
job (numpy arrays that nothing else references) over a bounded queue.
One writer thread is the consumer: npz serialization, crc read-back,
fsync, the manifest-last commit and retention pruning, the file I/O
that would otherwise block the step loop for the whole write.

The device-to-host pull stays on the train thread (``submit`` takes
host arrays): the updaters rewrite parameters and optimizer state in
place every step, so only an independent host copy is safe to write
while training goes on, and no CUDA tensor crosses to the writer.

A writer exception **latches** and re-raises on the train thread at the
next :meth:`~AsyncCheckpointWriter.submit` / ``poll`` / ``drain`` /
``close``: a run whose snapshots silently stopped landing is worse than
a dead run.  ``FAULT_HOOK`` is the crash-injection point for tests: a
callable raising mid-write makes the writer die as a kill at that byte
would (partial shard files, no manifest).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from . import prune_snapshots, write_snapshot

#: test-only crash injection: ``FAULT_HOOK(stage)`` is called after each
#: shard write and before the manifest (stage ``"shard:<name>"`` /
#: ``"manifest"``); raising simulates a kill at that point
FAULT_HOOK: Optional[Callable[[str], None]] = None


class _Job:
    __slots__ = ("path", "shards", "meta", "counter", "keep", "tracer")

    def __init__(self, path: str, shards: Dict[str, Dict[str, np.ndarray]],
                 meta: dict, counter: int, keep: int, tracer):
        self.path = path
        self.shards = shards
        self.meta = meta
        self.counter = counter
        self.keep = keep
        self.tracer = tracer


class AsyncCheckpointWriter:
    """One writer thread and a queue of one pending snapshot job: a
    submit while one snapshot is written and another waits blocks the
    train loop (backpressure, not loss), so at most three snapshots'
    host copies are alive.  ``on_done(stats)`` runs on the writer thread
    after each committed snapshot (the task driver emits its ``ckpt``
    record there)."""

    def __init__(self, on_done=None):
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=1)
        # racelint: latch(write-once by the writer thread; poll() re-raises on the train thread)
        self._failed: Optional[BaseException] = None
        self._on_done = on_done
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0  # racelint: guarded-by(self._lock, self._idle)
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._run, daemon=True, name="cxxnet-ckpt-writer")
        self._thread.start()

    # ------------------------------------------------------------- producer
    def poll(self) -> None:
        """Re-raise a latched writer failure on the calling thread."""
        if self._failed is not None:
            raise self._failed

    def _put(self, item) -> bool:
        """Bounded put that re-checks the failure latch, so a writer
        that died with a full queue cannot deadlock the train thread."""
        while self._failed is None:
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def submit(self, path: str, shards: Dict[str, Dict[str, np.ndarray]],
               meta: dict, *, counter: int, keep: int,
               tracer=None) -> float:
        """Enqueue one snapshot job (host arrays only); blocks while the
        queue is full.  ``tracer`` (the submitter's span tracer, looked up
        per job: a rollback swaps the trainer and its metrics) times the
        write's shards, manifest and retention pass (``ckpt_shard``,
        ``ckpt_manifest``, ``ckpt_prune``).  Returns the seconds the
        caller spent blocked here."""
        self.poll()
        if tracer is None:
            from ..monitor import spans
            tracer = spans.NULL
        t0 = time.perf_counter()
        with self._lock:
            self._pending += 1
        if not self._put(_Job(path, shards, meta, counter, keep, tracer)):
            self.poll()  # the writer died while we were blocked
        return time.perf_counter() - t0

    def drain(self) -> None:
        """Block until every submitted snapshot committed (or the writer
        failed: then re-raise)."""
        with self._idle:
            while self._pending > 0 and self._failed is None:
                self._idle.wait(timeout=0.05)
        self.poll()

    def close(self) -> None:
        """Drain, stop and join the writer; re-raises a latched failure
        after the thread is joined."""
        if self._thread is not None:
            self._put(None)  # skipped when the writer already died
            self._thread.join()
            self._thread = None
        self.poll()

    # ------------------------------------------------------------- consumer
    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                t0 = time.perf_counter()
                stats = write_snapshot(job.path, job.shards, job.meta,
                                       fault_hook=FAULT_HOOK,
                                       tracer=job.tracer)
                with job.tracer.span("ckpt_prune", keep=job.keep):
                    pruned = prune_snapshots(
                        os.path.dirname(job.path) or ".", job.keep)
                stats.update(write_sec=time.perf_counter() - t0,
                             path=job.path, counter=job.counter,
                             pruned=pruned)
                if self._on_done is not None:
                    self._on_done(stats)
            except BaseException as e:  # noqa: BLE001 — latched, re-raised
                self._failed = e
                with self._idle:
                    self._pending = 0
                    self._idle.notify_all()
                return
            with self._idle:
                self._pending -= 1
                self._idle.notify_all()

"""Token-level continuous batching: many client threads -> one decode
loop (the JAX package's ``StepScheduler``, ``serve/batcher.py``).

Client threads call :meth:`StepScheduler.submit`; one dispatcher thread
runs the decode loop.  Requests join and leave the in-flight batch
between single-token steps: a finished sequence's cache slot is freed
and refilled from the queue at once, so a short generation never waits
for the longest one (``continuous=True``).  ``continuous=False`` is
request-level batching — admit only into an empty batch and run it to
completion — the baseline continuous batching is measured against.

A runner exception latches the scheduler dead and reaches every active
and queued request: clients get the exception, never a hang.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..monitor.metrics import nearest_rank
from .decode import sample_token


class ServeClosed(RuntimeError):
    """Raised to submitters when the scheduler is shut down."""


@dataclasses.dataclass
class _GenRequest:
    prompt: np.ndarray
    max_new: int
    event: threading.Event
    t0: float
    rng: Optional[np.random.RandomState] = None
    tokens: Optional[list] = None       # generated ids (the result)
    pos: int = 0                        # next cache write position
    error: Optional[BaseException] = None


class StepScheduler:
    """Continuous batching over a decode ``runner`` (a
    :class:`~cxxnet_tpu_torch.serve.decode.DecodeEngine`, or anything
    with ``slots`` / ``max_seqlen`` / ``prefill(slot, tokens)`` /
    ``step(tokens, positions)``)."""

    def __init__(self, runner, *, max_new_tokens: int = 32, eos: int = -1,
                 sample: str = "greedy", temp: float = 1.0, topk: int = 0,
                 seed: int = 0, queue_depth: int = 64,
                 continuous: bool = True, metrics=None,
                 name: str = "decode"):
        self.runner = runner
        self.max_new_tokens = max(1, int(max_new_tokens))
        self.eos = int(eos)
        self.sample_kind = sample
        self.temp = float(temp)
        self.topk = int(topk)
        self.seed = int(seed)
        self.continuous = bool(continuous)
        self.metrics = metrics
        self.name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._thread: Optional[threading.Thread] = None
        self._failed: Optional[BaseException] = None
        self._closing = False
        self._draining = False
        self._active: Dict[int, _GenRequest] = {}
        self._free: List[int] = list(range(runner.slots))
        self._stats_lock = threading.Lock()
        self._req_seq = 0              # guarded by _stats_lock
        self._tok_lats: List[float] = []   # guarded by _stats_lock
        self._prefill_lats: List[float] = []  # decode-loop writer only
        # decode-loop-only writers
        self.n_requests = 0
        self.n_tokens = 0
        self.n_steps = 0
        self.n_prefills = 0
        self.occ_hist: Dict[int, int] = {}

    # ------------------------------------------------------------- client
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"cxxnet-decode-sched-{self.name}")
        self._thread.start()

    def submit(self, prompt: np.ndarray,
               max_new_tokens: Optional[int] = None) -> list:
        """One generation request: blocks until the sequence finishes (or
        the scheduler dies) and returns the generated token ids."""
        if self._failed is not None:
            raise self._failed
        if self._closing:
            raise ServeClosed(f"scheduler {self.name!r} is shut down")
        assert self._thread is not None, "call start() first"
        prompt = np.asarray(prompt).reshape(-1)
        limit = getattr(self.runner, "max_seqlen", None)
        if prompt.shape[0] < 1 or (limit is not None
                                   and prompt.shape[0] > limit):
            raise ValueError(f"submit: prompt of {prompt.shape[0]} tokens, "
                             f"cache holds 1..{limit}")
        with self._stats_lock:
            self._req_seq += 1
            rid = self._req_seq
        rng = np.random.RandomState((self.seed * 1000003 + rid) % (2 ** 31)) \
            if self.sample_kind != "greedy" else None
        req = _GenRequest(prompt=prompt,
                          max_new=int(max_new_tokens or self.max_new_tokens),
                          event=threading.Event(), t0=time.perf_counter(),
                          rng=rng)
        while True:
            if self._failed is not None:
                raise self._failed
            if self._closing:
                raise ServeClosed(f"scheduler {self.name!r} is shut down")
            try:
                self._q.put(req, timeout=0.05)
                break
            except queue.Full:
                continue
        while not req.event.wait(0.1):
            t = self._thread
            if t is None or not t.is_alive():
                self._drain(self._failed)
        if req.error is not None:
            raise req.error
        if self.metrics is not None:
            self.metrics.observe("gen_latency_sec",
                                 time.perf_counter() - req.t0)
        return req.tokens

    # --------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        batch_open = True
        while True:
            if not self._active:
                if self._draining:
                    return
                batch_open = True
                r = self._q.get()
                if r is None:
                    self._drain(None)
                    return
                if not self._admit(r):
                    return
            while self._free and not self._draining \
                    and (self.continuous or batch_open):
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    break
                if r is None:
                    self._draining = True
                    break
                if not self._admit(r):
                    return
            if not self._active:
                continue
            batch_open = False
            if not self._step_once():
                return

    def _sample(self, logits, req: _GenRequest) -> int:
        return sample_token(logits, self.sample_kind, self.temp, self.topk,
                            req.rng)

    def _done(self, req: _GenRequest, tok: int) -> bool:
        limit = getattr(self.runner, "max_seqlen", None)
        return (tok == self.eos or len(req.tokens) >= req.max_new
                or (limit is not None and req.pos >= limit))

    def _finish(self, slot: int, req: _GenRequest) -> None:
        self._free.append(slot)
        self._active.pop(slot, None)
        self.n_requests += 1
        req.event.set()

    def _admit(self, req: _GenRequest) -> bool:
        """Prefill ``req`` into a free slot and sample its first token;
        False latches the scheduler dead."""
        slot = self._free.pop()
        try:
            t0 = time.perf_counter()
            logits = self.runner.prefill(slot, req.prompt)
            self._prefill_lats.append(time.perf_counter() - t0)
            self.n_prefills += 1
            tok = self._sample(logits, req)
            req.tokens = [tok]
            req.pos = int(req.prompt.shape[0])
            self.n_tokens += 1
            if self._done(req, tok):
                self._finish(slot, req)
            else:
                self._active[slot] = req
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._free.append(slot)
            self._fail(e, extra=[req])
            return False

    def _step_once(self) -> bool:
        """One single-token step over every active slot; False latches
        the scheduler dead."""
        slots = self.runner.slots
        tokens = np.zeros((slots,), np.int32)
        positions = np.zeros((slots,), np.int32)
        for slot, req in self._active.items():
            tokens[slot] = req.tokens[-1]
            positions[slot] = req.pos
        n_active = len(self._active)
        try:
            t0 = time.perf_counter()
            logits = self.runner.step(tokens, positions)
            for slot in list(self._active):
                req = self._active[slot]
                tok = self._sample(logits[slot], req)
                req.tokens.append(tok)
                req.pos += 1
                self.n_tokens += 1
                if self._done(req, tok):
                    self._finish(slot, req)
            step_wall = time.perf_counter() - t0
            self.n_steps += 1
            self.occ_hist[n_active] = self.occ_hist.get(n_active, 0) + 1
            with self._stats_lock:
                self._tok_lats.append(step_wall)
            if self.metrics is not None:
                self.metrics.observe("token_latency_sec", step_wall)
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._fail(e)
            return False

    def _fail(self, e: BaseException, extra=()) -> None:
        self._failed = e
        for req in list(self._active.values()) + list(extra):
            req.error = e
            req.event.set()
        self._active.clear()
        self._drain(e)

    def _drain(self, err: Optional[BaseException]) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is None:
                continue
            r.error = err if err is not None else ServeClosed(
                f"scheduler {self.name!r} shut down before this request "
                "was served")
            r.event.set()

    # ------------------------------------------------------------ teardown
    def close(self) -> None:
        """Stop accepting requests, finish everything active and queued,
        join the dispatcher.  Idempotent."""
        self._closing = True
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join()
        self._thread = None
        self._drain(self._failed)

    # --------------------------------------------------------------- stats
    @property
    def mean_occupancy(self) -> float:
        if not self.occ_hist:
            return 0.0
        total = sum(self.occ_hist.values())
        return sum(k * v for k, v in self.occ_hist.items()) / total

    def stats(self) -> Dict[str, Any]:
        """Decode accounting for the ``serve_gen`` record: counts,
        occupancy histogram, step and prefill latency percentiles (ms)."""
        with self._stats_lock:
            lats = sorted(self._tok_lats)
        out: Dict[str, Any] = {
            "requests": self.n_requests, "tokens": self.n_tokens,
            "steps": self.n_steps, "prefills": self.n_prefills,
            "mean_occupancy": round(self.mean_occupancy, 2),
            "occupancy_hist": {str(k): v
                               for k, v in sorted(self.occ_hist.items())},
            "batching": "continuous" if self.continuous else "request"}
        if lats:
            out.update(tok_p50_ms=round(nearest_rank(lats, 50) * 1e3, 3),
                       tok_p95_ms=round(nearest_rank(lats, 95) * 1e3, 3),
                       tok_p99_ms=round(nearest_rank(lats, 99) * 1e3, 3))
        pre = sorted(self._prefill_lats)
        if pre:
            out.update(prefill_p50_ms=round(nearest_rank(pre, 50) * 1e3, 3))
        return out

"""Serving front ends: many client threads -> one device loop (the JAX
package's ``serve/batcher.py``).

* :class:`MicroBatcher` — client threads call :meth:`MicroBatcher.submit`
  with rows; one dispatcher thread drains the bounded request queue and
  coalesces concurrent requests into one predict call of up to
  ``max_batch`` rows, or whatever arrived within ``max_wait_ms`` of the
  batch opening.  Every op of an eval forward is row-independent, so a
  row's result does not depend on what it was batched with.  With
  ``track_window`` on it also counts the open window's requests,
  latencies and SLO violations for :meth:`MicroBatcher.window_stats`
  (the ``serve_window`` record).
* :class:`StepScheduler` — token-level continuous batching for
  generation.  Requests join and leave the in-flight batch between
  decode steps: a finished sequence's cache slot is freed and refilled
  from the queue at once, so a short generation never waits for the
  longest one (``continuous=True``).  ``continuous=False`` is
  request-level batching — admit only into an empty batch and run it to
  completion — the baseline continuous batching is measured against.
  With a draft runner and ``spec_k`` it decodes speculatively, and with
  ``prefill_chunk`` it streams prompts into the cache a chunk per tick.

In both, a runner exception latches the front dead and reaches every
waiting client: clients get the exception, never a hang.

Under ``trace_sample`` (the metrics' span tracer) a sampled request's
path is a chain of ``span`` records (doc/monitor.md): the batcher's
``queue_wait`` / ``coalesce`` / ``dispatch`` (the engine's ``pad`` /
``device`` / ``unpad`` inside it) / ``respond`` / ``request``, the
scheduler's ``prefill`` / ``prefill_chunk`` / ``decode`` / ``sample`` /
``draft`` / ``verify`` / ``request``.  A ``request`` span lasts exactly
the latency the request's histogram sample records.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..monitor.metrics import nearest_rank
from .decode import draw_from, sample_probs, sample_token


class ServeClosed(RuntimeError):
    """Raised to submitters when the batcher or scheduler is shut
    down."""


@dataclasses.dataclass
class _Request:
    data: np.ndarray
    event: threading.Event
    t0: float
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # span tracing: the sampled request's id and client thread, when the
    # dispatcher dequeued it and when its dispatch finished
    trace_id: Optional[int] = None
    tid: str = ""
    t_deq: float = 0.0
    t_served: float = 0.0


class MicroBatcher:
    """Bounded request queue + coalescing dispatcher over ``runner``
    (rows ``(n,) + input_shape`` -> output rows, row-aligned).

    ``submit`` is thread-safe and blocking: it enqueues the request
    (backpressure past ``queue_depth``), waits for the dispatch it rides
    in and returns its own slice of the result.  A dispatch never
    exceeds ``max_batch`` rows: a request that would overflow the open
    batch opens the next one (only a single request larger than
    ``max_batch`` dispatches alone, and the engine splits it across
    buckets).  A runner exception fails the whole batch and everything
    queued behind it, and latches the batcher dead."""

    def __init__(self, runner: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 queue_depth: int = 64, metrics=None, name: str = "serve"):
        self.runner = runner
        self.max_batch = max(1, int(max_batch))
        self.max_wait_ms = float(max_wait_ms)
        self.metrics = metrics
        self.name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._thread: Optional[threading.Thread] = None
        # racelint: latch(write-once by the dispatcher; racy reads fan the failure out to submitters)
        self._failed: Optional[BaseException] = None
        self._closing = False
        # dispatcher-only writers
        self.n_requests = 0    # racelint: atomic(plain-int bump, dispatcher is the only writer; scrape reads tolerate staleness)
        self.n_batches = 0     # racelint: atomic(plain-int bump, dispatcher-only writer)
        self.rows_served = 0   # racelint: atomic(plain-int bump, dispatcher-only writer)
        # racelint: atomic(per-key int bump, dispatcher-only writer; the scrape path copies via copy_racy)
        self.batch_hist: Dict[int, int] = {}
        # queue depth, sampled at arrival (submit) and at each dispatch
        self.depth_sum = 0      # racelint: guarded-by(self._stats_lock)
        self.depth_samples = 0  # racelint: guarded-by(self._stats_lock)
        self.depth_max = 0      # racelint: guarded-by(self._stats_lock)
        self._stats_lock = threading.Lock()
        # the serve_window stream (task_serve's reporter turns it on and
        # drains it with window_stats; off, submit pays one bool test):
        # latencies and requests of the open window and, with slo_ms set
        # (serve_slo_p99_ms), the requests slower than the SLO
        self.track_window = False
        self.slo_ms = 0.0
        self._win_lock = threading.Lock()
        self._win_lats: List[float] = []
        self._win_requests = 0
        self._win_viol = 0

    # ------------------------------------------------------------- client
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"cxxnet-serve-batcher-{self.name}")
        self._thread.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        """One request (``(n,) + input_shape`` rows); returns its output
        rows once the coalesced batch it rode in completes."""
        if self._failed is not None:
            raise self._failed
        if self._closing:
            raise ServeClosed(f"batcher {self.name!r} is shut down")
        assert self._thread is not None, "call start() first"
        tracer = self.metrics.tracer if self.metrics is not None else None
        req = _Request(data=np.asarray(x), event=threading.Event(),
                       t0=time.perf_counter())
        if tracer is not None and tracer.enabled:
            req.trace_id = tracer.new_trace()
            if req.trace_id is not None:
                req.tid = threading.current_thread().name
        # a bounded put that re-checks the latch: never block forever on
        # a dead batcher's full queue, nor enqueue behind the shutdown
        while True:
            if self._failed is not None:
                raise self._failed
            if self._closing:
                raise ServeClosed(f"batcher {self.name!r} is shut down")
            try:
                self._q.put(req, timeout=0.05)
                break
            except queue.Full:
                continue
        # a burst that arrives and drains between two dispatches is
        # visible only here
        self._observe_depth(self._q.qsize())
        # the latch can land between the check above and the put: if the
        # dispatcher is gone, release the queue ourselves
        while not req.event.wait(0.1):
            t = self._thread
            if t is None or not t.is_alive():
                self._drain(self._failed)
        if req.error is not None:
            raise req.error
        latency = time.perf_counter() - req.t0
        # t_served stays 0 when tracing went off before the dispatch
        if req.trace_id is not None and req.t_served > 0.0:
            # respond: the dispatch done -> this client returning;
            # request: the whole wall, the histogram's own sample
            tracer.emit("respond", req.t_served, req.t0 + latency,
                        trace_id=req.trace_id, model=self.name)
            tracer.emit("request", req.t0, req.t0 + latency,
                        trace_id=req.trace_id, model=self.name)
        if self.metrics is not None:
            self.metrics.observe("serve_latency_sec", latency)
        if self.track_window:
            with self._win_lock:
                self._win_lats.append(latency)
                self._win_requests += 1
                if self.slo_ms > 0.0 and latency * 1e3 > self.slo_ms:
                    self._win_viol += 1
        return req.result

    def _observe_depth(self, depth: int) -> None:
        with self._stats_lock:
            self.depth_sum += depth
            self.depth_samples += 1
            self.depth_max = max(self.depth_max, depth)

    def window_stats(self) -> Dict[str, Any]:
        """Drain the open window: its requests, the live queue depth, its
        latency p50 / p95 / p99 (ms) and, with ``slo_ms`` set, ``viol``
        (requests over it).  The reporter calls this once a
        ``serve_sentinel_window``."""
        with self._win_lock:
            lats, self._win_lats = self._win_lats, []
            n, self._win_requests = self._win_requests, 0
            viol, self._win_viol = self._win_viol, 0
        out: Dict[str, Any] = {"requests": n,
                               "queue_depth": self._q.qsize()}
        if self.slo_ms > 0.0:
            out["viol"] = viol
        if lats:
            lats.sort()
            out.update(p50_ms=round(nearest_rank(lats, 50) * 1e3, 3),
                       p95_ms=round(nearest_rank(lats, 95) * 1e3, 3),
                       p99_ms=round(nearest_rank(lats, 99) * 1e3, 3))
        return out

    # --------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        carry = None        # a request held back for the next batch
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                first = self._q.get()
                if first is None:
                    return
                first.t_deq = time.perf_counter()
            batch = [first]
            rows = first.data.shape[0]
            stop = False
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while rows < self.max_batch:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                try:
                    r = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if r is None:       # shutdown mid-coalesce: serve what
                    stop = True     # we have, then exit
                    break
                r.t_deq = time.perf_counter()
                if rows + r.data.shape[0] > self.max_batch:
                    carry = r
                    break
                batch.append(r)
                rows += r.data.shape[0]
            depth = self._q.qsize()
            self._observe_depth(depth)
            if self.metrics is not None:
                self.metrics.set_gauge("serve_queue_depth", depth)
            if not self._run(batch, rows):
                if carry is not None:   # latched: the held request fails
                    carry.error = self._failed
                    carry.event.set()
                return
            if stop:
                return

    def _run(self, batch, rows: int) -> bool:
        tracer = self.metrics.tracer if self.metrics is not None else None
        riders = [r.trace_id for r in batch if r.trace_id is not None] \
            if tracer is not None and tracer.enabled else []
        try:
            t_disp = time.perf_counter()
            for r in batch:
                if riders and r.trace_id is not None:
                    # a sampled rider's stages before the dispatch, on its
                    # client's track
                    tracer.emit("queue_wait", r.t0, r.t_deq,
                                trace_id=r.trace_id, tid=r.tid,
                                model=self.name)
                    tracer.emit("coalesce", r.t_deq, t_disp,
                                trace_id=r.trace_id, tid=r.tid,
                                model=self.name)
            data = batch[0].data if len(batch) == 1 else \
                np.concatenate([r.data for r in batch], axis=0)
            if riders:
                # the engine's pad / device / unpad spans take the riders
                # from the link
                with tracer.link(riders):
                    out = self.runner(data)
                t_done = time.perf_counter()
                tracer.emit("dispatch", t_disp, t_done, riders=riders,
                            rows=rows, requests=len(batch), model=self.name)
                for r in batch:
                    if r.trace_id is not None:
                        r.t_served = t_done
            else:
                out = self.runner(data)
            self.n_batches += 1
            self.n_requests += len(batch)
            self.rows_served += rows
            self.batch_hist[rows] = self.batch_hist.get(rows, 0) + 1
            if self.metrics is not None:
                self.metrics.observe("serve_batch_rows", rows)
            off = 0
            for r in batch:
                k = r.data.shape[0]
                r.result = out[off:off + k]
                off += k
                r.event.set()
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._failed = e
            for r in batch:
                r.error = e
                r.event.set()
            self._drain(e)
            return False

    def _drain(self, err: Optional[BaseException]) -> None:
        """Fail (or, after shutdown, reject) everything still queued."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is None:
                continue
            r.error = err if err is not None else ServeClosed(
                f"batcher {self.name!r} shut down before this request was "
                "served")
            r.event.set()

    # ------------------------------------------------------------ teardown
    def close(self) -> None:
        """Stop accepting requests, serve everything already queued, join
        the dispatcher and reject stragglers.  Idempotent."""
        self._closing = True
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join()
        self._thread = None
        self._drain(self._failed)

    @property
    def mean_batch(self) -> float:
        return self.rows_served / self.n_batches if self.n_batches else 0.0

    @property
    def mean_depth(self) -> float:
        with self._stats_lock:
            return self.depth_sum / self.depth_samples \
                if self.depth_samples else 0.0

    def stats(self) -> Dict[str, Any]:
        """Dispatch accounting for the ``serve`` record."""
        with self._stats_lock:
            depth_mean = self.depth_sum / self.depth_samples \
                if self.depth_samples else 0.0
            depth_max = self.depth_max
        return {"requests": self.n_requests, "batches": self.n_batches,
                "rows": self.rows_served,
                "mean_batch": round(self.mean_batch, 2),
                "batch_hist": {str(k): v
                               for k, v in sorted(self.batch_hist.items())},
                "queue_depth_mean": round(depth_mean, 2),
                "queue_depth_max": depth_max}


@dataclasses.dataclass
class _GenRequest:
    prompt: np.ndarray
    max_new: int
    event: threading.Event
    t0: float
    rng: Optional[np.random.RandomState] = None
    tokens: Optional[list] = None       # generated ids (the result)
    pos: int = 0                        # next cache write position
    # speculation: columns valid in the DRAFT cache.  Trails ``pos`` by
    # at most 1 (after a fully accepted block the draft never consumed
    # its own last proposal); the catch-up tick of the next round closes
    # the gap.  Rolling back a rejected tail is just this counter: the
    # length mask hides the stale columns
    dpos: int = 0
    # chunked prefill: the next chunk's offset into the prompt
    chunk_off: int = 0
    error: Optional[BaseException] = None
    # span tracing: the sampled request's id and client thread
    trace_id: Optional[int] = None
    tid: str = ""


class StepScheduler:
    """Continuous batching over a decode ``runner`` (a
    :class:`~cxxnet_tpu_torch.serve.decode.DecodeEngine`, or anything
    with ``slots`` / ``max_seqlen`` / ``prefill(slot, tokens)`` /
    ``step(tokens, positions)`` / ``block(tokens, positions)``).

    Speculative decoding (``draft`` + ``spec_k``): each round runs
    ``spec_k`` single-token steps on the DRAFT runner to propose a
    block, then ONE flagship ``block`` dispatch verifies all ``spec_k +
    1`` positions.  Greedy takes the longest prefix on which the draft
    agrees with the verified argmax, then the verified token, so its
    ids are plain greedy decode's (every verify row is the sequential
    step's row up to rounding); other kinds use rejection sampling off
    the verified distributions with the request's RandomState.  A
    rejected tail rolls both caches back by arithmetic on the length
    counters.

    Chunked prefill (``prefill_chunk``): a joining prompt streams into
    the cache ``prefill_chunk`` columns per ``block`` dispatch, one chunk
    tick between decode rounds, oldest joiner first, so a long prompt
    holds the in-flight requests back by at most one chunk a token."""

    def __init__(self, runner, *, max_new_tokens: int = 32, eos: int = -1,
                 sample: str = "greedy", temp: float = 1.0, topk: int = 0,
                 seed: int = 0, queue_depth: int = 64,
                 continuous: bool = True, draft=None, spec_k: int = 0,
                 prefill_chunk: int = 0, metrics=None,
                 name: str = "decode"):
        self.runner = runner
        self.max_new_tokens = max(1, int(max_new_tokens))
        self.eos = int(eos)
        self.sample_kind = sample
        self.temp = float(temp)
        self.topk = int(topk)
        self.seed = int(seed)
        self.continuous = bool(continuous)
        self.draft = draft
        self.spec_k = int(spec_k)
        self.prefill_chunk = int(prefill_chunk)
        self._spec = draft is not None and self.spec_k >= 1
        self.metrics = metrics
        self.name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._thread: Optional[threading.Thread] = None
        # racelint: latch(write-once by the decode loop; racy reads fan the failure out to submitters)
        self._failed: Optional[BaseException] = None
        self._closing = False
        self._draining = False
        self._active: Dict[int, _GenRequest] = {}
        # slots mid-chunked-prefill, and their admission order (FIFO)
        self._filling: Dict[int, _GenRequest] = {}
        self._fill_order: List[int] = []
        self._free: List[int] = list(range(runner.slots))
        self._stats_lock = threading.Lock()
        self._req_seq = 0  # racelint: guarded-by(self._stats_lock)
        self._tok_lats: List[float] = []  # racelint: guarded-by(self._stats_lock)
        # decode-loop-only writers
        self._prefill_lats: List[float] = []  # racelint: atomic(list append, decode-loop-only writer; stats() sorts a GIL-atomic copy)
        self._chunk_lats: List[float] = []    # racelint: atomic(list append, decode-loop-only writer; stats() sorts a GIL-atomic copy)
        self.n_requests = 0        # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_tokens = 0          # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_steps = 0           # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_prefills = 0        # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_prefill_chunks = 0  # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_draft_steps = 0     # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_verify_calls = 0    # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_spec_proposed = 0   # racelint: atomic(plain-int bump, decode-loop-only writer)
        self.n_spec_accepted = 0   # racelint: atomic(plain-int bump, decode-loop-only writer)
        self._draft_wall = 0.0     # racelint: atomic(float bump, decode-loop-only writer)
        self._verify_wall = 0.0    # racelint: atomic(float bump, decode-loop-only writer)
        # racelint: atomic(per-key int bump, decode-loop-only writer; scrape copies via copy_racy)
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
        tracer = self.metrics.tracer if self.metrics is not None else None
        req = _GenRequest(prompt=prompt,
                          max_new=int(max_new_tokens or self.max_new_tokens),
                          event=threading.Event(), t0=time.perf_counter(),
                          rng=rng)
        if tracer is not None and tracer.enabled:
            req.trace_id = tracer.new_trace()
            if req.trace_id is not None:
                req.tid = threading.current_thread().name
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
        latency = time.perf_counter() - req.t0
        if req.trace_id is not None:
            tracer.emit("request", req.t0, req.t0 + latency,
                        trace_id=req.trace_id, tid=req.tid,
                        model=self.name, tokens=len(req.tokens))
        if self.metrics is not None:
            self.metrics.observe("gen_latency_sec", latency)
        return req.tokens

    # --------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        batch_open = True
        while True:
            if not self._active and not self._filling:
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
            # one chunk tick for the oldest joining prompt, between
            # decode rounds
            if self._filling and not self._chunk_tick():
                return
            if not self._active:
                continue
            batch_open = False
            if not (self._spec_round() if self._spec
                    else self._step_once()):
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
        """Prefill ``req`` into a free slot (or queue it for chunked
        prefill); False latches the scheduler dead."""
        slot = self._free.pop()
        if self.prefill_chunk > 0:
            req.chunk_off = 0
            self._filling[slot] = req
            self._fill_order.append(slot)
            return True
        try:
            t0 = time.perf_counter()
            logits = self.runner.prefill(slot, req.prompt)
            t1 = time.perf_counter()
            self._prefill_lats.append(t1 - t0)
            if req.trace_id is not None:
                self.metrics.tracer.emit(
                    "prefill", t0, t1, trace_id=req.trace_id, slot=slot,
                    prompt=int(req.prompt.shape[0]), model=self.name)
            self.n_prefills += 1
            self._activate(slot, req, logits)
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._free.append(slot)
            self._fail(e, extra=[req])
            return False

    def _activate(self, slot: int, req: _GenRequest, logits) -> None:
        """The prompt is in the cache: prefill the draft (speculation),
        sample the first token off the last prompt position's ``logits``
        and move ``req`` into the active batch (or finish it).  The
        caller handles exceptions."""
        plen = int(req.prompt.shape[0])
        if self._spec:
            t0 = time.perf_counter()
            self.draft.prefill(slot, req.prompt)
            t1 = time.perf_counter()
            self._draft_wall += t1 - t0
            if req.trace_id is not None:
                self.metrics.tracer.emit("draft", t0, t1,
                                         trace_id=req.trace_id, slot=slot,
                                         prompt=plen, model=self.name)
        req.dpos = plen
        tok = self._sample(logits, req)
        req.tokens = [tok]
        req.pos = plen
        self.n_tokens += 1
        if self._done(req, tok):
            self._free.append(slot)
            self.n_requests += 1
            req.event.set()
        else:
            self._active[slot] = req

    def _base_positions(self) -> np.ndarray:
        """Each slot's next FLAGSHIP cache write column: an idle slot
        rides a batched dispatch there, and what it writes sits past its
        length mask until the dispatch that first computes there
        overwrites it."""
        positions = np.zeros((self.runner.slots,), np.int32)
        for slot, req in self._active.items():
            positions[slot] = req.pos
        for slot, req in self._filling.items():
            positions[slot] = req.chunk_off
        return positions

    def _chunk_tick(self) -> bool:
        """One chunked-prefill dispatch: the next ``prefill_chunk``
        prompt columns of the oldest joining request, every other slot
        riding at its own next column.  The last chunk activates the
        request.  False latches the scheduler dead."""
        slot = self._fill_order[0]
        req = self._filling[slot]
        C = self.prefill_chunk
        off = req.chunk_off
        plen = int(req.prompt.shape[0])
        tokens = np.zeros((self.runner.slots, C), np.int32)
        positions = self._base_positions()
        chunk = req.prompt[off:off + C]
        tokens[slot, :chunk.shape[0]] = chunk
        positions[slot] = off
        try:
            t0 = time.perf_counter()
            logits = self.runner.block(tokens, positions)
            t1 = time.perf_counter()
            self._chunk_lats.append(t1 - t0)
            if req.trace_id is not None:
                self.metrics.tracer.emit(
                    "prefill_chunk", t0, t1, trace_id=req.trace_id,
                    slot=slot, offset=off, model=self.name)
            self.n_prefill_chunks += 1
            req.chunk_off = off + C
            if req.chunk_off >= plen:
                self._fill_order.pop(0)
                del self._filling[slot]
                self.n_prefills += 1
                # the last prompt position's row: the whole-prompt
                # prefill's row, up to rounding
                self._activate(slot, req, logits[slot, plen - 1 - off])
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            # req may already be out of _filling (activation raised)
            self._fail(e, extra=[] if req.event.is_set() else [req])
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
        riders = self._riders()
        try:
            t0 = time.perf_counter()
            if riders:
                with self.metrics.tracer.link(riders):
                    logits = self.runner.step(tokens, positions)
            else:
                logits = self.runner.step(tokens, positions)
            t1 = time.perf_counter()
            for slot in list(self._active):
                req = self._active[slot]
                tok = self._sample(logits[slot], req)
                req.tokens.append(tok)
                req.pos += 1
                self.n_tokens += 1
                if self._done(req, tok):
                    self._finish(slot, req)
            t2 = time.perf_counter()
            if riders:
                tr = self.metrics.tracer
                tr.emit("decode", t0, t1, riders=riders, active=n_active,
                        model=self.name)
                tr.emit("sample", t1, t2, riders=riders, active=n_active,
                        model=self.name)
            self._round_done(n_active, t2 - t0)
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._fail(e)
            return False

    def _riders(self) -> List[int]:
        """The trace ids of the sampled active requests (empty when the
        tracer is off)."""
        tracer = self.metrics.tracer if self.metrics is not None else None
        if tracer is None or not tracer.enabled:
            return []
        return [r.trace_id for r in self._active.values()
                if r.trace_id is not None]

    def _round_done(self, n_active: int, wall: float) -> None:
        self.n_steps += 1
        self.occ_hist[n_active] = self.occ_hist.get(n_active, 0) + 1
        with self._stats_lock:
            self._tok_lats.append(wall)
        if self.metrics is not None:
            self.metrics.observe("token_latency_sec", wall)

    def _draft_positions(self) -> np.ndarray:
        """Each slot's next DRAFT cache write column; idle slots ride at
        0 (a filling or free slot's draft row is rewritten by its draft
        prefill at activation)."""
        positions = np.zeros((self.runner.slots,), np.int32)
        for slot, req in self._active.items():
            positions[slot] = req.dpos
        return positions

    def _spec_round(self) -> bool:
        """One speculative round over every active slot: (1) a draft
        catch-up step for slots whose draft cache trails the flagship by
        one column, (2) ``spec_k`` draft steps proposing a block, (3) ONE
        flagship ``block`` dispatch verifying all ``spec_k + 1``
        positions, (4) acceptance on the host.  False latches the
        scheduler dead."""
        slots = self.runner.slots
        k = self.spec_k
        greedy = self.sample_kind == "greedy"
        n_active = len(self._active)
        riders = self._riders()
        round_draft_steps = 0
        try:
            t0 = time.perf_counter()
            # (1) catch-up: the true token at the draft's next column;
            # the other slots ride at their own next column, which the
            # first proposal step overwrites
            if any(req.dpos < req.pos for req in self._active.values()):
                tokens = np.zeros((slots,), np.int32)
                positions = self._draft_positions()
                for slot, req in self._active.items():
                    if req.dpos < req.pos:
                        plen = int(req.prompt.shape[0])
                        tokens[slot] = req.tokens[req.dpos - plen]
                self.draft.step(tokens, positions)
                round_draft_steps += 1
                for req in self._active.values():
                    if req.dpos < req.pos:
                        req.dpos += 1
            # (2) spec_k proposals: the pending token first, then the
            # draft's own
            props = np.zeros((slots, k), np.int32)
            dprobs: Dict = {}           # (slot, j) -> draft distribution
            feed = np.zeros((slots,), np.int32)
            for slot, req in self._active.items():
                feed[slot] = req.tokens[-1]
            for j in range(k):
                logits = self.draft.step(feed, self._draft_positions())
                round_draft_steps += 1
                for slot, req in self._active.items():
                    if greedy:
                        d = int(np.argmax(logits[slot]))
                    else:
                        p = sample_probs(logits[slot], self.sample_kind,
                                         self.temp, self.topk)
                        d = draw_from(p, req.rng)
                        dprobs[(slot, j)] = p
                    props[slot, j] = d
                    feed[slot] = d
                    req.dpos += 1
            t1 = time.perf_counter()
            self._draft_wall += t1 - t0
            # (3) verify the pending token and the k proposals in one
            # flagship dispatch over all slots
            vtokens = np.zeros((slots, k + 1), np.int32)
            for slot, req in self._active.items():
                vtokens[slot, 0] = req.tokens[-1]
                vtokens[slot, 1:] = props[slot]
            if riders:
                with self.metrics.tracer.link(riders):
                    logits = self.runner.block(vtokens,
                                               self._base_positions())
            else:
                logits = self.runner.block(vtokens, self._base_positions())
            self.n_verify_calls += 1
            t2 = time.perf_counter()
            self._verify_wall += t2 - t1
            # (4) acceptance and emission
            for slot in list(self._active):
                req = self._active[slot]
                emitted = self._accept(req, slot, logits, props, dprobs,
                                       greedy)
                m = len(emitted) - 1        # proposals accepted
                self.n_spec_proposed += k
                self.n_spec_accepted += m
                # the draft lags by 1 only after a fully accepted block
                req.dpos = req.pos + 1 + min(m, k - 1)
                for tok in emitted:
                    req.tokens.append(tok)
                    req.pos += 1
                    self.n_tokens += 1
                    if self._done(req, tok):
                        self._finish(slot, req)
                        break
            t3 = time.perf_counter()
            if riders:
                tr = self.metrics.tracer
                tr.emit("draft", t0, t1, riders=riders, active=n_active,
                        model=self.name)
                tr.emit("verify", t1, t2, riders=riders, active=n_active,
                        model=self.name)
                tr.emit("sample", t2, t3, riders=riders, active=n_active,
                        model=self.name)
            self._round_done(n_active, t3 - t0)
            self.n_draft_steps += round_draft_steps
            if self.metrics is not None:
                self.metrics.counter_inc("spec_draft_steps",
                                         round_draft_steps)
                self.metrics.counter_inc("spec_verify_calls")
                if self.n_spec_proposed:
                    self.metrics.set_gauge(
                        "spec_accept_rate",
                        self.n_spec_accepted / self.n_spec_proposed)
            return True
        except BaseException as e:  # noqa: BLE001 — must reach clients
            self._fail(e)
            return False

    def _accept(self, req: _GenRequest, slot: int, logits, props, dprobs,
                greedy: bool) -> list:
        """The tokens one verify row set emits for ``slot``: the accepted
        proposals, then the verified (greedy) or resampled token."""
        k = self.spec_k
        emitted = []
        if greedy:
            # the first disagreeing position emits the VERIFIED token,
            # so even a draft that is never right leaves greedy ids
            for i in range(k + 1):
                g = int(np.argmax(logits[slot, i]))
                emitted.append(g)
                if i < k and props[slot, i] != g:
                    break
            return emitted
        for i in range(k):
            pt = sample_probs(logits[slot, i], self.sample_kind, self.temp,
                              self.topk)
            pd = dprobs[(slot, i)]
            d = int(props[slot, i])
            if req.rng.random_sample() * pd[d] < pt[d]:
                emitted.append(d)
                continue
            res = np.maximum(pt - pd, 0.0)
            tot = res.sum()
            emitted.append(draw_from(res / tot, req.rng) if tot > 0.0
                           else draw_from(pt, req.rng))
            return emitted
        pt = sample_probs(logits[slot, k], self.sample_kind, self.temp,
                          self.topk)
        emitted.append(draw_from(pt, req.rng))
        return emitted

    def _fail(self, e: BaseException, extra=()) -> None:
        """Latch dead and fan the exception out to every active,
        chunk-prefilling and queued request."""
        self._failed = e
        for req in (list(self._active.values())
                    + list(self._filling.values()) + list(extra)):
            req.error = e
            req.event.set()
        self._active.clear()
        self._filling.clear()
        self._fill_order.clear()
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
        """Decode accounting for the ``serve_gen`` record (the JAX
        package's keys): counts, occupancy histogram, the speculative
        and chunk counters, step latency percentiles (ms), and the
        port's prefill and chunk-tick p50s."""
        with self._stats_lock:
            lats = sorted(self._tok_lats)
        out: Dict[str, Any] = {
            "requests": self.n_requests, "tokens": self.n_tokens,
            "steps": self.n_steps, "prefills": self.n_prefills,
            "mean_occupancy": round(self.mean_occupancy, 2),
            "occupancy_hist": {str(k): v
                               for k, v in sorted(self.occ_hist.items())},
            "batching": "continuous" if self.continuous else "request"}
        if self._spec:
            out.update(
                spec_k=self.spec_k, draft_steps=self.n_draft_steps,
                verify_calls=self.n_verify_calls,
                acceptance_rate=round(
                    self.n_spec_accepted / self.n_spec_proposed, 4)
                if self.n_spec_proposed else 0.0,
                draft_ms=round(self._draft_wall * 1e3, 3),
                verify_ms=round(self._verify_wall * 1e3, 3))
        if self.prefill_chunk > 0:
            out.update(prefill_chunk=self.prefill_chunk,
                       prefill_chunks=self.n_prefill_chunks)
        if lats:
            out.update(tok_p50_ms=round(nearest_rank(lats, 50) * 1e3, 3),
                       tok_p95_ms=round(nearest_rank(lats, 95) * 1e3, 3),
                       tok_p99_ms=round(nearest_rank(lats, 99) * 1e3, 3))
        for key, vals in (("prefill_p50_ms", self._prefill_lats),
                          ("chunk_p50_ms", self._chunk_lats)):
            if vals:
                out[key] = round(nearest_rank(sorted(vals), 50) * 1e3, 3)
        return out

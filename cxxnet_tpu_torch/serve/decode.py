"""Incremental-decode engine: KV-cached autoregressive generation (the
JAX package's ``serve/decode.py`` in PyTorch).

* **prefill** — one prompt row, zero-padded to the net's input width
  (``max_seqlen``), runs the normal causal forward; every attention
  layer hands its fresh ``(k, v)`` to the engine, which copies them into
  the cache row of the request's slot.
* **block(W)** — ``W`` consecutive positions per slot: every attention
  layer writes the new ``(k, v)`` columns into the cache at ``positions
  + w`` and query ``w`` attends over the whole cache under the length
  mask ``arange(max_seqlen) <= position + w``.  The speculative verify
  takes ``W = spec_k + 1``, the chunked-prefill tick ``W =
  decode_prefill_chunk``.
* **step** — the block dispatch at ``W = 1``: ONE position per slot.
  Row ``w`` of a block is the sequential step's row at that position up
  to the GEMMs' reduction
  order, which cuBLAS (like XLA) picks by the row count: greedy token
  ids agree, logits to rounding (not bitwise, in the JAX package
  either).

Shapes stay static (prefill at the full width, step at ``slots``, block
at ``slots x W`` for each declared width), so a later CUDA-graph capture
can take them.  The cache is updated in place, so decoding allocates no
new cache memory.  ``kv_dtype`` stores the cache in float32 or bfloat16
whatever the net's dtype: cast on write, read back in the activations'
dtype, scores and ``p·V`` in float32.  Sampling runs on the host off
the f32 logits (:func:`sample_token`, :func:`sample_probs`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..layers.base import DecodeState
from ..layers.loss import LossLayerBase
from ..layers.sequence import AttentionLayer

#: ordered sampling kinds (serve_gen_sample)
SAMPLE_KINDS = ("greedy", "temperature", "topk")

_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def sample_token(logits: np.ndarray, kind: str = "greedy",
                 temp: float = 1.0, topk: int = 0,
                 rng: Optional[np.random.RandomState] = None) -> int:
    """One token id off a ``(vocab,)`` logits row: ``greedy`` argmax,
    ``temperature`` softmax sampling of ``logits / temp``, ``topk`` the
    same restricted to the ``topk`` highest logits.  ``rng`` is the
    request's RandomState, so replays are deterministic."""
    if kind == "greedy":
        return int(np.argmax(logits))
    if kind not in SAMPLE_KINDS:
        raise ValueError(f"serve_gen_sample = {kind!r}: expected one of "
                         f"{'/'.join(SAMPLE_KINDS)}")
    return draw_from(sample_probs(logits, kind, temp, topk), rng)


def sample_probs(logits: np.ndarray, kind: str = "temperature",
                 temp: float = 1.0, topk: int = 0) -> np.ndarray:
    """The ``(vocab,)`` f64 distribution :func:`sample_token` draws from
    under ``kind`` / ``temp`` / ``topk``: what speculative rejection
    sampling needs explicitly (accept proposal ``d`` with ``min(1,
    p_target(d) / p_draft(d))``, resample a reject from
    ``normalize(max(p_target - p_draft, 0))``)."""
    if kind not in SAMPLE_KINDS or kind == "greedy":
        raise ValueError(f"sample_probs: kind {kind!r} has no sampling "
                         "distribution (greedy is argmax)")
    z = np.asarray(logits, np.float64) / max(float(temp), 1e-6)
    if kind == "topk":
        k = max(1, int(topk))
        if k < z.shape[0]:
            keep = np.argpartition(z, -k)[-k:]
            masked = np.full_like(z, -np.inf)
            masked[keep] = z[keep]
            z = masked
    p = np.exp(z - z.max())
    return p / p.sum()


def draw_from(p: np.ndarray, rng) -> int:
    """Inverse-CDF draw from a probability vector, the cumsum /
    searchsorted arithmetic of :func:`sample_token`: a draw from
    ``sample_probs(logits, ...)`` with the same rng state lands on the
    same id."""
    r = (rng.random_sample() if rng is not None
         else np.random.random_sample())
    return int(min(np.searchsorted(np.cumsum(p), r), p.shape[0] - 1))


class DecodeEngine:
    """KV-cached incremental decode over a loaded LM trainer.  Call
    :meth:`prefill` / :meth:`step` / :meth:`block` from one thread (the
    scheduler's).  ``block_widths`` are the block widths :meth:`warmup`
    runs; a dispatch at any other width counts in :attr:`retraces` (the
    JAX package compiles such a width on demand)."""

    def __init__(self, trainer, *, slots: int = 4, max_seqlen: int = 0,
                 metrics=None, kv_dtype: str = "",
                 block_widths: Sequence[int] = ()):
        if trainer.net is None:
            raise ValueError("DecodeEngine needs an initialized/loaded "
                             "trainer")
        if trainer.mesh is not None and trainer.mesh.size > 1:
            raise ValueError(
                "incremental decode runs single-device for now "
                f"(mesh has {trainer.mesh.size} devices); drop the "
                "mesh_shape for task=serve generation")
        self.trainer = trainer
        self.metrics = metrics if metrics is not None else trainer.metrics
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"decode_slots = {slots}: must be >= 1")
        net = trainer.net
        in_shape = net.node_shapes[0]
        if in_shape[1] != 1 or in_shape[2] != 1:
            raise ValueError(
                "incremental decode needs a token-id input "
                f"(b,1,1,seq); the netconfig input is {in_shape}")
        self.max_seqlen = int(max_seqlen) or int(in_shape[3])
        if self.max_seqlen != int(in_shape[3]):
            raise ValueError(
                f"decode_max_seqlen = {self.max_seqlen} but the netconfig "
                f"input width is {in_shape[3]}; prefill runs the net at its "
                "declared width, so the two must match")
        self._att: List[Tuple[int, AttentionLayer]] = []
        self._head_end: Optional[int] = None
        self._logits_node: Optional[int] = None
        for i, conn in enumerate(net.connections):
            if isinstance(conn.layer, AttentionLayer):
                if not conn.layer.causal:
                    raise ValueError(
                        "incremental decode requires causal = 1 on every "
                        f"attention layer (connection {i} is bidirectional)")
                self._att.append((i, conn.layer))
            elif isinstance(conn.layer, LossLayerBase) \
                    and self._head_end is None:
                self._head_end = i
                self._logits_node = conn.nindex_in[0]
        if not self._att:
            raise ValueError("incremental decode needs at least one "
                             "attention layer (not an LM netconfig?)")
        if self._head_end is None:
            raise ValueError("incremental decode needs a softmax_seq (or "
                             "other loss) self-loop marking the LM head")
        if len({id(l) for _, l in self._att}) != len(self._att):
            raise ValueError("incremental decode does not support shared "
                             "attention layers")
        for i, layer in self._att:
            layer.decode_key = f"a{i}"
        self.nhead = self._att[0][1].nhead
        dim = net.node_shapes[net.connections[self._att[0][0]]
                              .nindex_in[0]][3]
        self.head_dim = dim // self.nhead
        self.vocab = int(net.node_shapes[self._logits_node][3])
        if kv_dtype not in ("", "f32", "bf16"):
            raise ValueError(f"decode_kv_dtype = {kv_dtype!r}: expected f32 "
                             "or bf16")
        # "" = the net's dtype; either may hold the other's cache
        self.kv_dtype = kv_dtype or (
            "bf16" if net.dtype == torch.bfloat16 else "f32")
        self.block_widths = tuple(sorted({int(w) for w in block_widths
                                          if int(w) > 0}))
        for w in self.block_widths:
            if w > self.max_seqlen:
                raise ValueError(f"block width {w} exceeds "
                                 f"decode_max_seqlen = {self.max_seqlen}")
        self._warm_widths = set(self.block_widths)
        self.device = trainer.device
        with torch.inference_mode():
            shape = (self.slots, self.nhead, self.max_seqlen, self.head_dim)
            dt = _KV_DTYPES[self.kv_dtype]
            self._caches = {layer.decode_key: {
                "k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _, layer in self._att}
        self.warmup_sec = 0.0
        self.warmed = False
        self.retraces = 0
        # call accounting (the decode loop is the only writer)
        self.prefill_calls = 0
        self.step_calls = 0
        self.block_calls = 0
        self.prompt_tokens = 0

    # -------------------------------------------------------------- build
    def kv_cache_bytes(self) -> int:
        """2 (k and v) per attention layer, at the cache's dtype."""
        itemsize = 2 if self.kv_dtype == "bf16" else 4
        return (2 * len(self._att) * self.slots * self.nhead
                * self.max_seqlen * self.head_dim * itemsize)

    def footprint(self) -> Dict[str, int]:
        """Resident bytes on the device: the weights (and buffers), the
        optimizer state the trainer holds there (the port keeps a loaded
        snapshot's on the host until the first update) and the KV
        cache."""
        t = self.trainer
        weight = _tree_bytes(t.params) + _tree_bytes(t.buffers)
        opt = _tree_bytes(t.opt_state or {})
        kv = self.kv_cache_bytes()
        fp = {"weight_bytes": weight, "opt_bytes": opt,
              "kv_cache_bytes": kv, "buckets": 2 + len(self.block_widths),
              "total_bytes": weight + opt + kv}
        if self.kv_dtype == "bf16":
            # what the narrower cache saves against a float32 one
            fp["kv_saved_bytes"] = kv
        return fp

    def stats(self) -> Dict[str, object]:
        """Call accounting: prefill / step / block calls, prompt tokens
        and the cache geometry."""
        return {"prefill_calls": self.prefill_calls,
                "step_calls": self.step_calls,
                "block_calls": self.block_calls,
                "prompt_tokens": self.prompt_tokens,
                "slots": self.slots, "max_seqlen": self.max_seqlen,
                "kv_dtype": self.kv_dtype,
                "kv_cache_bytes": self.kv_cache_bytes(),
                "warmup_sec": round(self.warmup_sec, 3)}

    def warmup(self) -> None:
        """Run one prefill, one step and one block per declared width
        (builds the CUDA kernels at first use and warms the libraries),
        then wait for the device.  The columns written land in slot
        rows that their next prefill rewrites or their length mask
        hides."""
        t0 = time.perf_counter()
        self._prefill(0, np.zeros((1,), np.int32))
        zeros = np.zeros((self.slots,), np.int32)
        self._step(zeros, zeros)
        for w in self.block_widths:
            self._block(np.zeros((self.slots, w), np.int32), zeros)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed = True
        self.warmup_sec = time.perf_counter() - t0

    # ------------------------------------------------------------- decode
    def _run_net(self, ids: torch.Tensor, dec: Optional[DecodeState]):
        """Raw (b, 1, s, V) logits: the forward up to the loss head."""
        t = self.trainer
        nodes = t.net.forward(t.params, {0: ids}, t.context(dec),
                              until=self._head_end)
        return nodes[self._logits_node]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; from pinned memory
        without blocking on the card, so the forward's launches queue
        behind the copy."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _ids(self, tokens: np.ndarray, shape) -> torch.Tensor:
        ids = np.zeros(shape, np.float32)
        flat = np.asarray(tokens).reshape(-1)
        ids.reshape(-1)[:flat.shape[0]] = flat
        return self._to_device(ids)

    def _prefill(self, slot: int, tokens: np.ndarray) -> np.ndarray:
        L = tokens.shape[0]
        S = self.max_seqlen
        with torch.inference_mode():
            dec = DecodeState(mode="prefill", caches={}, max_seqlen=S)
            logits = self._run_net(self._ids(tokens, (1, 1, 1, S)), dec)
            for key, kv in dec.caches.items():
                self._caches[key]["k"][slot].copy_(kv["k"][0])
                self._caches[key]["v"][slot].copy_(kv["v"][0])
            return logits[0, 0, L - 1].float().cpu().numpy()

    def _step(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        tokens = np.asarray(tokens).reshape(self.slots, 1)
        return self._block(tokens, positions)[:, 0]

    def _block(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        W = tokens.shape[1]
        S = self.max_seqlen
        # positions clipped below the cache end (the JAX package's clip);
        # the cells written are those of the W columns from there that
        # lie inside the cache, built here so the write needs no
        # device-side mask
        pos = np.clip(np.asarray(positions, np.int64), 0, S - 1)
        cols = pos[:, None] + np.arange(W)
        rows, frm = np.nonzero(cols < S)
        n = rows.shape[0]
        index = self._to_device(np.concatenate(
            [pos, rows, cols[rows, frm], frm]).astype(np.int64))
        with torch.inference_mode():
            dec = DecodeState(mode="block", caches=self._caches,
                              positions=index[:self.slots],
                              write_rows=index[self.slots:self.slots + n],
                              write_cols=index[self.slots + n:
                                               self.slots + 2 * n],
                              write_from=index[self.slots + 2 * n:],
                              max_seqlen=S)
            logits = self._run_net(self._ids(tokens, (self.slots, 1, 1, W)),
                                   dec)
            return logits[:, 0, :, :].float().cpu().numpy()

    def prefill(self, slot: int, tokens: np.ndarray) -> np.ndarray:
        """Fill ``slot``'s cache with ``tokens`` (a 1-D prompt of
        1..max_seqlen ids) and return the f32 ``(vocab,)`` logits at the
        last prompt position."""
        tokens = np.asarray(tokens).reshape(-1)
        L = tokens.shape[0]
        if not 0 < L <= self.max_seqlen:
            raise ValueError(f"prefill: prompt of {L} tokens, but the cache "
                             f"holds 1..{self.max_seqlen}")
        if not 0 <= slot < self.slots:
            raise ValueError(f"prefill: slot {slot} out of "
                             f"0..{self.slots - 1}")
        self.prefill_calls += 1
        self.prompt_tokens += L
        return self._prefill(slot, tokens)

    def step(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """One decode step for ALL slots: append ``tokens[i]`` at
        ``positions[i]`` in slot i's cache and return the f32
        ``(slots, vocab)`` next-token logits.  An idle slot passes
        position 0; its row is discarded and its cache row is rewritten
        by its next prefill."""
        self.step_calls += 1
        return self._step(tokens, positions)

    def block(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """One multi-column dispatch for ALL slots: append ``tokens[i,
        w]`` at ``positions[i] + w`` in slot i's cache and return the f32
        ``(slots, W, vocab)`` logits; row ``w`` is the next-token
        distribution after position ``positions[i] + w``.  A width not
        in ``block_widths`` counts one retrace at its first dispatch (the
        scheduler never sends one).  Slots not taking part pass their own
        next write position: what lands there sits past their length
        mask and is overwritten by the dispatch that first computes
        there."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.slots:
            raise ValueError(f"block: tokens of shape {tokens.shape}, "
                             f"expected ({self.slots}, width)")
        W = int(tokens.shape[1])
        if not 0 < W <= self.max_seqlen:
            raise ValueError(f"block: width {W} out of "
                             f"1..{self.max_seqlen}")
        if W not in self._warm_widths:
            self._warm_widths.add(W)
            self.retraces += 1
        self.block_calls += 1
        return self._block(tokens, positions)

    def full_logits(self, tokens: np.ndarray) -> np.ndarray:
        """The cache-free reference: a plain eval forward over the
        zero-padded prompt, ``(max_seqlen, vocab)`` f32 logits."""
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.shape[0] > self.max_seqlen:
            raise ValueError("full_logits: prompt exceeds max_seqlen")
        with torch.inference_mode():
            logits = self._run_net(
                self._ids(tokens, (1, 1, 1, self.max_seqlen)), None)
            return logits[0, 0].float().cpu().numpy()


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return 0

"""Incremental-decode engine: KV-cached autoregressive generation (the
JAX package's ``serve/decode.py`` in PyTorch).

* **prefill** — one prompt row, zero-padded to the net's input width
  (``max_seqlen``), runs the normal causal forward; every attention
  layer hands its fresh ``(k, v)`` to the engine, which copies them into
  the cache row of the request's slot.
* **step** — ONE position per slot: every attention layer writes the
  new ``(k, v)`` into the cache at ``positions`` and attends over the
  whole cache under the length mask ``arange(max_seqlen) <= position``.

Shapes stay static (prefill at the full width, step at ``slots``), so a
later CUDA-graph capture can take both.  The cache is updated in place,
so decoding allocates no new cache memory.  Sampling runs on the host
off the f32 logits (:func:`sample_token`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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
    z = np.asarray(logits, np.float64) / max(float(temp), 1e-6)
    if kind == "topk":
        k = max(1, int(topk))
        if k < z.shape[0]:
            keep = np.argpartition(z, -k)[-k:]
            masked = np.full_like(z, -np.inf)
            masked[keep] = z[keep]
            z = masked
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    r = (rng.random_sample() if rng is not None
         else np.random.random_sample())
    return int(min(np.searchsorted(np.cumsum(p), r), z.shape[0] - 1))


class DecodeEngine:
    """KV-cached incremental decode over a loaded LM trainer.  Call
    :meth:`prefill` / :meth:`step` from one thread (the scheduler's)."""

    def __init__(self, trainer, *, slots: int = 4, max_seqlen: int = 0,
                 metrics=None, kv_dtype: str = ""):
        if trainer.net is None:
            raise ValueError("DecodeEngine needs an initialized/loaded "
                             "trainer")
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
        net_kv = "bf16" if net.dtype == torch.bfloat16 else "f32"
        if kv_dtype and kv_dtype != net_kv:
            raise ValueError(
                f"decode_kv_dtype = {kv_dtype} under a {net_kv} net is not "
                "ported to cxxnet_tpu_torch yet (ROADMAP.md)")
        self.kv_dtype = net_kv
        self.device = trainer.device
        with torch.inference_mode():
            shape = (self.slots, self.nhead, self.max_seqlen, self.head_dim)
            self._caches = {layer.decode_key: {
                "k": torch.zeros(shape, dtype=_KV_DTYPES[net_kv],
                                 device=self.device),
                "v": torch.zeros(shape, dtype=_KV_DTYPES[net_kv],
                                 device=self.device)}
                for _, layer in self._att}
        self.warmup_sec = 0.0
        self.prefill_calls = 0
        self.step_calls = 0
        self.prompt_tokens = 0

    # -------------------------------------------------------------- build
    def kv_cache_bytes(self) -> int:
        itemsize = 2 if self.kv_dtype == "bf16" else 4
        return (2 * len(self._att) * self.slots * self.nhead
                * self.max_seqlen * self.head_dim * itemsize)

    def footprint(self) -> Dict[str, int]:
        """Resident bytes on the device: weights plus the KV cache."""
        weight = sum(t.numel() * t.element_size()
                     for g in self.trainer.params.values()
                     for t in g.values())
        kv = self.kv_cache_bytes()
        return {"weight_bytes": weight, "kv_cache_bytes": kv,
                "total_bytes": weight + kv}

    def warmup(self) -> None:
        """Run one prefill and one step (builds the CUDA kernels at first
        use and warms the libraries), then wait for the device.  Slot 0's
        cache row is rewritten by its next prefill."""
        t0 = time.perf_counter()
        self._prefill(0, np.zeros((1,), np.int32))
        self._step(np.zeros((self.slots,), np.int32),
                   np.zeros((self.slots,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_sec = time.perf_counter() - t0

    # ------------------------------------------------------------- decode
    def _run_net(self, ids: torch.Tensor, dec: Optional[DecodeState]):
        """Raw (b, 1, s, V) logits: the forward up to the loss head."""
        t = self.trainer
        nodes = t.net.forward(t.params, {0: ids}, t.context(dec),
                              until=self._head_end)
        return nodes[self._logits_node]

    def _ids(self, tokens: np.ndarray, shape) -> torch.Tensor:
        ids = np.zeros(shape, np.float32)
        flat = np.asarray(tokens).reshape(-1)
        ids.reshape(-1)[:flat.shape[0]] = flat
        return torch.from_numpy(ids).to(self.device)

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
        S = self.max_seqlen
        with torch.inference_mode():
            pos = torch.from_numpy(
                np.clip(np.asarray(positions, np.int64), 0, S - 1)
            ).to(self.device)
            dec = DecodeState(mode="step", caches=self._caches,
                              positions=pos, max_seqlen=S)
            logits = self._run_net(self._ids(tokens, (self.slots, 1, 1, 1)),
                                   dec)
            return logits[:, 0, 0, :].float().cpu().numpy()

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

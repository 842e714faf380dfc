"""Tokenized-LM dataset path: binary token shards + document packing.

The reference framework's identity is its config-driven binary data
pipeline (im2bin pages + iterator chains); this module is the im2bin
analogue for language models, the modality the reference predates
entirely (SURVEY.md §5.7: data is fixed (N,C,H,W) images).

Token-shard format (``tools/tok2bin.py`` writes it; fresh, documented —
mirrors the CXTPUBIN header discipline of ``io/imbin.py``)::

    file   := header doc_index tokens
    header := magic "CXTPUTOK" (8 bytes) | uint32 version | uint32 itemsize
              | uint64 ndocs | uint64 ntokens
    doc_index := (ndocs + 1) uint64 token offsets (offsets[0] = 0,
              offsets[ndocs] = ntokens)
    tokens := ntokens little-endian unsigned ints of ``itemsize`` bytes

Tokens are read via ``np.memmap`` — a shard is never loaded whole; the
doc-offset index is the only eagerly-resident part.  Multi-part shards
use ``path_tok = prefix_%d.tok`` with ``tok_count = N`` and distributed
workers take every k-th shard (``dist_num_worker``/``dist_worker_rank``,
or PS_RANK), exactly like the imgbin sharding.

Two iterator stages build on it (registered in ``io/factory.py``):

* :class:`TextIterator` — base stage yielding one document per
  ``next()`` (a 1-D int32 token array in ``DataInst.data``), with
  deterministic seeded per-epoch shuffling of shard order AND document
  order (seed ``787 + seed_data + gen`` — the epoch counter IS the
  cross-round resume state, the ImageBinIterator discipline).
* :class:`PackedSeqIterator` — packs variable-length documents into
  fixed ``(batch, seqlen)`` rows.  Default mode (``pack_split = 1``)
  chops the concatenated document stream, so every emitted position is
  a real token (packing efficiency 1.0) and the leftover tail CARRIES
  ACROSS the epoch boundary in a ragged buffer instead of being padded
  away; ``pack_split = 0`` keeps documents whole per row (padding where
  the next document doesn't fit — the mode whose packing-efficiency
  number is non-trivial).  Each row carries three label fields laid out
  for ``label_vec`` routing::

      label[:, 0:S)   next-token targets; -1 marks positions whose
                      target crosses a document boundary or is padding
                      (the loss layer masks these: softmax_seq
                      ``packed = 1``)
      label[:, S:2S)  segment ids, 1..k per row in order of appearance;
                      0 = padding (attention ``segment_key`` blocks
                      cross-segment scores)
      label[:, 2S:3S) position within the document, reset at every
                      document start (embedding ``pos_key``)

Both stages implement the ``state()/set_state()`` resume contract
(doc/checkpoint.md): the packer serializes its ragged buffer so a
kill-resume replays the exact token/row pairing bitwise.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from ..analysis.schema import K
from ..monitor import log as mlog
from .data import DataBatch, DataInst, IIterator

TOK_MAGIC = b"CXTPUTOK"
TOK_VERSION = 1
_HEADER_FMT = "<IIQQ"  # version, itemsize, ndocs, ntokens
_HEADER_SIZE = 8 + struct.calcsize(_HEADER_FMT)


def write_token_shard(path: str, docs, itemsize: int = 4) -> int:
    """Write one token shard (tools/tok2bin.py's engine).  ``docs`` is an
    iterable of int sequences; returns the number of documents written.
    ``itemsize`` 2 (uint16, vocab < 65536) or 4 (uint32).  The write
    goes through ``serializer.atomic_write`` — the repo's ONE copy of
    the tmp+fsync+replace+dir-fsync durability protocol."""
    assert itemsize in (2, 4), f"itemsize must be 2 or 4, got {itemsize}"
    offsets = [0]
    arrays = []
    le = "<u2" if itemsize == 2 else "<u4"
    for d in docs:
        a = np.asarray(d, np.int64)
        assert a.ndim == 1, "each document must be a 1-D token sequence"
        assert a.size > 0, "empty documents cannot be packed"
        assert a.min() >= 0, "token ids must be non-negative"
        assert a.max() < (1 << (8 * itemsize)), \
            f"token id {a.max()} exceeds itemsize {itemsize} range"
        arrays.append(np.ascontiguousarray(a.astype(le)))
        offsets.append(offsets[-1] + a.size)

    def _write(f):
        f.write(TOK_MAGIC + struct.pack(_HEADER_FMT, TOK_VERSION, itemsize,
                                        len(arrays), offsets[-1]))
        f.write(np.asarray(offsets, "<u8").tobytes())
        for a in arrays:
            f.write(a.tobytes())

    from ..utils.serializer import atomic_write
    atomic_write(path, _write)
    return len(arrays)


class TokenShard:
    """Memory-mapped reader of one token shard: the doc-offset index is
    eagerly resident, token data stays on disk behind ``np.memmap``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(_HEADER_SIZE)
        assert head[:8] == TOK_MAGIC, f"{path}: not a CXTPUTOK file"
        version, itemsize, ndocs, ntokens = struct.unpack(
            _HEADER_FMT, head[8:])
        assert version == TOK_VERSION, \
            f"{path}: version {version} != {TOK_VERSION}"
        assert itemsize in (2, 4), f"{path}: bad itemsize {itemsize}"
        self.ndocs = int(ndocs)
        self.ntokens = int(ntokens)
        self.offsets = np.fromfile(path, "<u8", self.ndocs + 1,
                                   offset=_HEADER_SIZE)
        assert self.offsets.size == self.ndocs + 1, f"{path}: truncated index"
        assert int(self.offsets[-1]) == self.ntokens, \
            f"{path}: index/token count mismatch"
        dtype = np.dtype("<u2" if itemsize == 2 else "<u4")
        self.tokens = np.memmap(
            path, dtype=dtype, mode="r",
            offset=_HEADER_SIZE + 8 * (self.ndocs + 1), shape=(self.ntokens,))

    def doc(self, i: int) -> np.ndarray:
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        return np.asarray(self.tokens[a:b], np.int32)


class TextIterator(IIterator):
    """Token-shard document reader with deterministic per-epoch shuffle.

    ``shuffle = 1`` reshuffles shard order and per-shard document order
    every epoch with seed ``787 + seed_data + gen``; the epoch counter
    ``gen`` is therefore the whole cross-round resume state (positions
    rewind at each ``before_first`` — the ImageBinIterator contract)."""

    config_keys = (
        K("path_tok", "path", help="token shard, %d with tok_count"),
        K("tok_count", "int", lo=0),
        K("shuffle", "int", lo=0, hi=1),
        K("silent", "int", lo=0, hi=1),
        K("seed_data", "int"),
        K("dist_num_worker", "int", lo=1),
        K("dist_worker_rank", "int", lo=0),
        K("text_max_docs", "int", lo=0,
          help="cap documents per epoch (0 = all; debug/CI sizing)"),
    )

    def __init__(self):
        self.path_tok = ""
        self.tok_count = 0
        self.shuffle = 0
        self.silent = 0
        self.seed_data = 0
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.text_max_docs = 0
        self._gen = 0

    def set_param(self, name, val):
        if name == "path_tok":
            self.path_tok = val
        elif name == "tok_count":
            self.tok_count = int(val)
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "seed_data":
            self.seed_data = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "text_max_docs":
            self.text_max_docs = int(val)

    def init(self):
        assert self.path_tok, "text: set path_tok"
        rank = int(os.environ.get("PS_RANK", self.dist_worker_rank))
        if self.tok_count > 0:
            shard_ids = [i for i in range(self.tok_count)
                         if i % self.dist_num_worker == rank]
            assert shard_ids, (
                f"text: worker rank {rank} of {self.dist_num_worker} maps "
                f"to no shards (tok_count = {self.tok_count}); a rank with "
                "zero data would dispatch no steps and hang the other "
                "replicas' collectives")
            paths = [self.path_tok % i for i in shard_ids]
        else:
            assert self.dist_num_worker == 1, \
                "distributed sharding needs tok_count > 1 shards"
            paths = [self.path_tok]
        self.shards = [TokenShard(p) for p in paths]
        # global doc id base per shard, so DataInst.index is stable under
        # shuffling (shard-local ordinal + base)
        self._doc_base = np.cumsum([0] + [s.ndocs for s in self.shards])
        self._ndocs = int(self._doc_base[-1])
        if not self.silent:
            ntok = sum(s.ntokens for s in self.shards)
            mlog.info(f"TextIterator: {self._ndocs} docs / {ntok} "
                      f"tokens in {len(self.shards)} shard(s)")

    def before_first(self):
        self._gen += 1
        order = []
        shard_order = list(range(len(self.shards)))
        rng = None
        if self.shuffle:
            rng = np.random.RandomState(787 + self.seed_data + self._gen)
            rng.shuffle(shard_order)
        for b in shard_order:
            docs = np.arange(self.shards[b].ndocs)
            if rng is not None:
                rng.shuffle(docs)
            order.extend((b, int(d)) for d in docs)
        if self.text_max_docs > 0:
            order = order[:self.text_max_docs]
        self._order = order
        self._pos = 0

    def next(self):
        if self._pos >= len(self._order):
            return None
        b, d = self._order[self._pos]
        self._pos += 1
        return DataInst(label=np.zeros((1,), np.float32),
                        data=self.shards[b].doc(d),
                        index=int(self._doc_base[b]) + d)

    def state(self):
        # captured at a round boundary (epoch drained): the per-epoch
        # shuffle is fully determined by gen, so the counter is the state
        return {"gen": int(self._gen)}

    def set_state(self, st):
        self._gen = max(int(st.get("gen", 0)), self._gen)


class PackedSeqIterator(IIterator):
    """Packs base documents into fixed ``(batch, seqlen)`` LM rows.

    ``pack_split = 1`` (default): the concatenated document stream is
    chopped into rows — zero padding, leftover tokens carry across the
    epoch boundary in the ragged buffer (serialized by :meth:`state` so
    kill-resume replays the exact pairing).  ``pack_split = 0``: whole
    documents per row, padded flush when the next document doesn't fit
    (documents longer than ``seqlen`` are truncated, counted in
    :meth:`stats`).

    Emits :class:`DataBatch` with ``data`` ``(b, 1, 1, S)`` float32
    token ids and ``label`` ``(b, 3S)`` = [targets | segments |
    positions] (module docstring has the exact field semantics)."""

    config_keys = (
        K("seqlen", "int", lo=2),
        K("batch_size", "int", lo=1),
        K("pack_split", "int", lo=0, hi=1,
          help="1 = chop the doc stream (no padding, ragged carry); "
               "0 = whole docs per row, padded flush"),
        K("silent", "int", lo=0, hi=1),
    )

    def __init__(self, base: IIterator):
        self.base = base
        self.seqlen = 0
        self.batch_size = 0
        self.pack_split = 1
        self.silent = 0
        # ragged stream buffer: parallel int64 arrays of (token, doc uid,
        # position-in-doc) — numpy on the hot path (per-token python
        # loops would dominate input time at real corpus scale);
        # state() converts to JSON-able int lists
        self._tok = np.zeros(0, np.int64)
        self._uid = np.zeros(0, np.int64)
        self._pos = np.zeros(0, np.int64)
        # pack_split = 0: finished-but-unemitted rows, each a dict of
        # three int64 arrays (already padded to seqlen)
        self._rows: List[dict] = []
        self._next_uid = 1
        self._batches_emitted = 0
        # counters behind stats()/packing efficiency
        self._real_tokens = 0
        self._total_positions = 0
        self._truncated_tokens = 0

    def set_param(self, name, val):
        if name == "seqlen":
            self.seqlen = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "pack_split":
            self.pack_split = int(val)
        elif name == "silent":
            self.silent = int(val)
        self.base.set_param(name, val)

    def init(self):
        assert self.seqlen >= 2, "packseq: set seqlen >= 2"
        assert self.batch_size > 0, "packseq: set batch_size"
        self.base.init()

    def before_first(self):
        # the ragged buffer deliberately survives the rewind: leftover
        # tokens from the previous epoch head the next one (no padding
        # wasted at epoch boundaries)
        self.base.before_first()

    # ------------------------------------------------------------ packing
    def _pull_doc(self) -> bool:
        inst = self.base.next()
        if inst is None:
            return False
        toks = np.asarray(inst.data, np.int64).reshape(-1)
        uid = self._next_uid
        self._next_uid += 1
        if self.pack_split:
            self._tok = np.concatenate([self._tok, toks])
            self._uid = np.concatenate(
                [self._uid, np.full(toks.size, uid, np.int64)])
            self._pos = np.concatenate(
                [self._pos, np.arange(toks.size, dtype=np.int64)])
        else:
            self._append_doc_nosplit(toks, uid)
        return True

    def _append_doc_nosplit(self, toks: np.ndarray, uid: int) -> None:
        s = self.seqlen
        if toks.size > s:
            self._truncated_tokens += toks.size - s
            toks = toks[:s]
        if self._tok.size + toks.size > s:
            self._flush_row_nosplit()
        self._tok = np.concatenate([self._tok, toks])
        self._uid = np.concatenate(
            [self._uid, np.full(toks.size, uid, np.int64)])
        self._pos = np.concatenate(
            [self._pos, np.arange(toks.size, dtype=np.int64)])

    def _flush_row_nosplit(self) -> None:
        """Pad the current (whole-docs) row out to seqlen and bank it."""
        if not self._tok.size:
            return
        pad = np.zeros(self.seqlen - self._tok.size, np.int64)
        self._rows.append({
            "tok": np.concatenate([self._tok, pad]),
            "uid": np.concatenate([self._uid, pad]),
            "pos": np.concatenate([self._pos, pad]),
        })
        self._tok = self._uid = self._pos = np.zeros(0, np.int64)

    def _row_arrays(self, tok, uid, pos, look_tok=None, look_uid=None):
        """(tokens, targets, segments, positions) for one row; target -1
        exactly where the next token belongs to another document or is
        padding.  ``look_tok``/``look_uid`` are the stream token right
        AFTER the row (split mode): a document continuing into the next
        row keeps its last-position target, so no supervision is lost at
        row boundaries."""
        s = self.seqlen
        tok = np.asarray(tok, np.int64)
        uid = np.asarray(uid, np.int64)
        pos = np.asarray(pos, np.int64)
        # renumber doc uids 1..k in order of appearance; 0 stays padding
        seg = np.zeros(s, np.int64)
        nz = uid != 0
        if nz.any():
            u, first, inv = np.unique(uid[nz], return_index=True,
                                      return_inverse=True)
            rank = np.empty(u.size, np.int64)
            rank[np.argsort(first)] = np.arange(1, u.size + 1)
            seg[nz] = rank[inv]
        tgt = np.full(s, -1, np.int64)
        same = (uid[:-1] == uid[1:]) & (uid[:-1] != 0)
        tgt[:-1][same] = tok[1:][same]
        if look_uid is not None and uid[-1] != 0 and look_uid == uid[-1]:
            tgt[-1] = look_tok
        self._real_tokens += int(nz.sum())
        self._total_positions += s
        return tok, tgt, seg, np.minimum(pos, s - 1)

    def _take_rows(self):
        """Up to batch_size packed rows, or None when the buffered stream
        cannot fill a whole batch (carry to the next epoch).  Split mode
        requires one token of LOOKAHEAD past the batch so every row-
        boundary target is known (the lookahead token stays buffered —
        it is the next batch's first token)."""
        b, s = self.batch_size, self.seqlen
        if self.pack_split:
            if self._tok.size < b * s + 1:
                return None
            rows = []
            for r in range(b):
                sl = slice(r * s, (r + 1) * s)
                la = (r + 1) * s
                rows.append(self._row_arrays(
                    self._tok[sl], self._uid[sl], self._pos[sl],
                    look_tok=int(self._tok[la]),
                    look_uid=int(self._uid[la])))
            self._tok = self._tok[b * s:]
            self._uid = self._uid[b * s:]
            self._pos = self._pos[b * s:]
            return rows
        if len(self._rows) < b:
            return None
        rows = [self._row_arrays(r["tok"], r["uid"], r["pos"])
                for r in self._rows[:b]]
        del self._rows[:b]
        return rows

    def next(self):
        while True:
            rows = self._take_rows()
            if rows is not None:
                break
            if not self._pull_doc():
                # epoch end: in nosplit mode bank the open row (its docs
                # are complete — only row-count, not content, is ragged);
                # if that completes a batch, emit it before ending
                if not self.pack_split and self._tok.size:
                    self._flush_row_nosplit()
                    rows = self._take_rows()
                    if rows is not None:
                        break
                return None
        b, s = self.batch_size, self.seqlen
        data = np.stack([r[0] for r in rows]).astype(np.float32)
        label = np.concatenate(
            [np.stack([r[1] for r in rows]),
             np.stack([r[2] for r in rows]),
             np.stack([r[3] for r in rows])], axis=1).astype(np.float32)
        idx = np.arange(self._batches_emitted * b,
                        self._batches_emitted * b + b, dtype=np.uint32)
        self._batches_emitted += 1
        return DataBatch(data=data.reshape(b, 1, 1, s), label=label,
                         index=idx)

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Packing counters: ``packing_efficiency`` is the real-token
        fraction of all emitted positions (1.0 in split mode)."""
        eff = (self._real_tokens / self._total_positions
               if self._total_positions else 0.0)
        return {"rows": self._total_positions // max(self.seqlen, 1),
                "real_tokens": self._real_tokens,
                "total_positions": self._total_positions,
                "truncated_tokens": self._truncated_tokens,
                "packing_efficiency": round(eff, 4)}

    # ------------------------------------------------------------- resume
    def state(self):
        st = {"tok": [int(t) for t in self._tok],
              "uid": [int(u) for u in self._uid],
              "pos": [int(p) for p in self._pos],
              "next_uid": int(self._next_uid),
              "emitted": int(self._batches_emitted),
              "real": int(self._real_tokens),
              "total": int(self._total_positions),
              "trunc": int(self._truncated_tokens),
              "base": self.base.state()}
        if not self.pack_split:
            st["rows"] = [{k: [int(x) for x in r[k]]
                           for k in ("tok", "uid", "pos")}
                          for r in self._rows]
        return st

    def set_state(self, st):
        self._tok = np.asarray(st.get("tok", []), np.int64)
        self._uid = np.asarray(st.get("uid", []), np.int64)
        self._pos = np.asarray(st.get("pos", []), np.int64)
        self._rows = [{k: np.asarray(r[k], np.int64)
                       for k in ("tok", "uid", "pos")}
                      for r in st.get("rows", [])]
        self._next_uid = int(st.get("next_uid", 1))
        self._batches_emitted = int(st.get("emitted", 0))
        self._real_tokens = int(st.get("real", 0))
        self._total_positions = int(st.get("total", 0))
        self._truncated_tokens = int(st.get("trunc", 0))
        if "base" in st:
            self.base.set_state(st["base"])

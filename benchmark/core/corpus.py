"""The LM traffic's documents and the token shard the program reads.

Every seed gets the same multiset of document lengths (drawn once from
the mix's own ``length_seed``: lognormal around ``median_len``, clipped
to ``[min_len, max_len]``), in an order and with tokens of its own: a
learnable corpus of 16 phrases of 8..32 ids over the vocabulary, each
document a run of phrases cut to its length (the kind of corpus
``chip_smoke.py`` ``phrase_docs`` makes, so the loss falls).

The shard is written in the program's documented token-shard format
(``cxxnet_tpu_torch/io/text.py``): magic ``CXTPUTOK``, uint32 version 1,
uint32 itemsize, uint64 documents, uint64 tokens, (documents + 1) uint64
offsets, then the tokens.
"""

from __future__ import annotations

import math
import struct
from typing import List

import numpy as np

from .weights import stream_seed


def lengths(traffic: dict, n_tokens: int) -> np.ndarray:
    """The mix's document lengths, at least ``n_tokens`` in all: the same
    for every seed."""
    rng = np.random.default_rng(int(traffic["length_seed"]))
    mu = math.log(traffic["median_len"])
    out, total = [], 0
    while total < n_tokens:
        n = rng.lognormal(mu, traffic["sigma_len"], 4096)
        n = np.clip(np.rint(n), traffic["min_len"], traffic["max_len"])
        out.append(n.astype(np.int64))
        total += int(n.sum())
    lens = np.concatenate(out)
    keep = int(np.searchsorted(np.cumsum(lens), n_tokens)) + 1
    return lens[:keep]


def documents(traffic: dict, seed: int, n_tokens: int, vocab: int
              ) -> List[np.ndarray]:
    """The seed's documents (uint16 or uint32 ids), ``n_tokens`` or more."""
    lens = lengths(traffic, n_tokens)
    rng = np.random.default_rng(stream_seed(seed, "docs"))
    lens = lens[rng.permutation(lens.size)]
    dtype = np.uint16 if vocab <= 65536 else np.uint32
    phrases = [rng.integers(0, vocab, int(rng.integers(8, 33))).astype(dtype)
               for _ in range(16)]
    mean = sum(p.size for p in phrases) / len(phrases)
    docs = []
    for n in lens:
        picks = rng.integers(0, len(phrases), int(n / mean * 1.5) + 4)
        doc = np.concatenate([phrases[i] for i in picks])
        while doc.size < n:
            doc = np.concatenate([doc, phrases[int(rng.integers(16))]])
        docs.append(doc[:n])
    return docs


def write_shard(path: str, docs: List[np.ndarray]) -> None:
    itemsize = docs[0].dtype.itemsize
    offs = np.zeros(len(docs) + 1, np.uint64)
    offs[1:] = np.cumsum([d.size for d in docs])
    with open(path, "wb") as f:
        f.write(b"CXTPUTOK")
        f.write(struct.pack("<IIQQ", 1, itemsize, len(docs), int(offs[-1])))
        f.write(offs.astype("<u8").tobytes())
        for d in docs:
            f.write(d.astype(d.dtype.newbyteorder("<")).tobytes())

"""Iterator chain factory (the JAX package's ``io/factory.py``) over the
stages ported so far: ``iter = mnist`` (MNIST idx files), ``iter =
text`` (token-shard documents) and ``iter = packseq`` (fixed ``(batch,
seqlen)`` LM rows) — the chains that feed ``task = train`` its batches,
the ``eval`` sections theirs and ``task = serve`` its prompts.  Keys
seen in a section are forwarded to every stage, as in the reference."""

from __future__ import annotations

from typing import List, Tuple

from .data import IIterator
from .iter_mnist import MNISTIterator
from .text import PackedSeqIterator, TextIterator


def create_iterator(cfg: List[Tuple[str, str]]) -> IIterator:
    it: IIterator = None
    pending: List[Tuple[str, str]] = []
    for name, val in cfg:
        if name == "iter":
            if val == "mnist":
                assert it is None, "mnist cannot chain over another iterator"
                it = MNISTIterator()
            elif val == "text":
                assert it is None, "text cannot chain over another iterator"
                it = TextIterator()
            elif val == "packseq":
                assert it is not None, "must specify input of packseq"
                it = PackedSeqIterator(it)
            elif val == "end":
                continue
            else:
                raise ValueError(f"iterator type {val!r} is not ported to "
                                 "cxxnet_tpu_torch yet (mnist, text, packseq "
                                 "are)")
            for n, v in pending:
                it.set_param(n, v)
            continue
        if it is not None:
            it.set_param(name, val)
        else:
            pending.append((name, val))
    assert it is not None, "must specify iterator by iter=itername"
    return it


def init_iterator(it: IIterator, defcfg: List[Tuple[str, str]]) -> IIterator:
    """Apply global config then ``init`` (reference InitIter)."""
    for n, v in defcfg:
        it.set_param(n, v)
    it.init()
    return it

"""Iterator chain factory (the JAX package's ``io/factory.py``; reference
``src/io/data.cpp:23-74``).

``iter = mnist|img|imgbin|imgbinx|imbin_native|text`` create base
iterators (img / imgbin are wrapped ``BatchAdapt(Augment(base))`` exactly
like the reference; ``imbin_native`` is the C++ loader, which assembles
batches itself; ``text`` yields token-shard documents, io/text.py);
``iter = threadbuffer|membuffer|attachtxt|packseq`` stack on top
(``packseq`` packs documents into fixed (batch, seqlen) LM rows).  All
config keys seen so far in the section are forwarded to every stage
(reference: SetParam on the whole chain).
"""

from __future__ import annotations

from typing import List, Tuple

from .data import IIterator
from .imbin import ImageBinIterator, ImageIterator
from .iter_mnist import MNISTIterator
from .iter_proc import (AttachTxtIterator, AugmentIterator,
                        BatchAdaptIterator, DenseBufferIterator,
                        ThreadBufferIterator)
from .text import PackedSeqIterator, TextIterator

#: ``iter = <name>`` -> the stage classes that name instantiates, in wrap
#: order.  ``imbin_native`` is listed lazily below (its module binds the
#: C++ loader).
ITER_STAGES = {
    "mnist": (MNISTIterator,),
    "img": (BatchAdaptIterator, AugmentIterator, ImageIterator),
    "imgbin": (BatchAdaptIterator, AugmentIterator, ImageBinIterator),
    "imgbinx": (BatchAdaptIterator, AugmentIterator, ImageBinIterator),
    "threadbuffer": (ThreadBufferIterator,),
    "membuffer": (DenseBufferIterator,),
    "attachtxt": (AttachTxtIterator,),
    "text": (TextIterator,),
    "packseq": (PackedSeqIterator,),
}


def iter_stage_classes(name: str):
    """Stage classes for one ``iter =`` value, or None when unknown."""
    if name == "imbin_native":
        from .native import NativeImageBinIterator
        return (NativeImageBinIterator,)
    return ITER_STAGES.get(name)


def iter_type_names():
    return sorted(ITER_STAGES) + ["imbin_native", "end"]


def create_iterator(cfg: List[Tuple[str, str]]) -> IIterator:
    it: IIterator = None
    pending: List[Tuple[str, str]] = []
    for name, val in cfg:
        if name == "iter":
            if val == "mnist":
                assert it is None, "mnist cannot chain over another iterator"
                it = MNISTIterator()
            elif val == "imgbin" or val == "imgbinx":
                assert it is None, "imgbin cannot chain over another iterator"
                it = BatchAdaptIterator(AugmentIterator(ImageBinIterator()))
                if val == "imgbinx":
                    # the reference's imgbinx adds a decode thread stage
                    # (iter_thread_imbin_x-inl.hpp); overridable by a later
                    # decode_thread_num key
                    it.set_param("decode_thread_num", "2")
            elif val == "imbin_native":
                # C++ loader: decode + normalize + batch assembly off-Python
                from .native import NativeImageBinIterator
                assert it is None, \
                    "imbin_native cannot chain over another iterator"
                it = NativeImageBinIterator()
            elif val == "img":
                assert it is None, "img cannot chain over another iterator"
                it = BatchAdaptIterator(AugmentIterator(ImageIterator()))
            elif val == "text":
                assert it is None, "text cannot chain over another iterator"
                it = TextIterator()
            elif val == "packseq":
                assert it is not None, "must specify input of packseq"
                it = PackedSeqIterator(it)
            elif val == "threadbuffer":
                assert it is not None, "must specify input of threadbuffer"
                it = ThreadBufferIterator(it)
            elif val == "membuffer":
                assert it is not None, "must specify input of membuffer"
                it = DenseBufferIterator(it)
            elif val == "attachtxt":
                assert it is not None, "must specify input of attachtxt"
                it = AttachTxtIterator(it)
            elif val == "end":
                continue
            else:
                raise ValueError(f"unknown iterator type {val!r}")
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

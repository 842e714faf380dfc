"""Binary image-pack format + paged prefetching iterator + im2bin packer
(the JAX package's ``io/imbin.py``: page files byte-equal to its, the
same shuffle seeds, cv2 JPEG decode imported at first use).

Reference: ``src/utils/io.h:254-326`` (BinaryPage: fixed 64MB pages with an
offset table), ``src/io/iter_thread_imbin-inl.hpp`` (background page
prefetch thread + jpeg decode), ``tools/im2bin.cpp`` (packer).

Our page format (fresh, documented; not byte-compatible with the reference):

    file   := header page*
    header := magic "CXTPUBIN" (8 bytes) | uint32 version | uint64 page_size
    page   := uint32 nrec | nrec * record | zero padding to page_size
    record := uint32 length | length bytes (raw jpeg)

Records never span pages (a record larger than a page is an error at pack
time).  Labels and instance indices come from the companion ``.lst`` file
("index label filename" lines, reference tools/im2bin.cpp), read in lockstep
like the reference's label loading (iter_thread_imbin-inl.hpp).

Multi-part shards: ``path_imgbin`` / ``path_imglst`` may contain ``%d`` with
``imgbin_count = N`` (reference's ``image_conf_prefix`` sharding), and
distributed workers take every k-th shard via ``dist_num_worker`` /
``dist_worker_rank`` (or the PS_RANK env var) —
iter_thread_imbin-inl.hpp:189-220.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
from typing import List, Optional

import numpy as np

from ..analysis.schema import K
from ..monitor import log as mlog
from .data import DataInst, IIterator

MAGIC = b"CXTPUBIN"
VERSION = 1
DEFAULT_PAGE_SIZE = 64 << 20  # 64MB, reference page size


class BinaryPageWriter:
    def __init__(self, path: str, page_size: int = DEFAULT_PAGE_SIZE):
        # incremental page stream (push() per image, O(page) memory);
        # data-prep reruns on a torn shard, so no atomic_write staging
        self.f = open(path, "wb")  # disclint: ok(atomic-write)
        self.page_size = page_size
        self.f.write(MAGIC + struct.pack("<IQ", VERSION, page_size))
        self._recs: List[bytes] = []
        self._used = 4  # nrec field

    def push(self, payload: bytes) -> None:
        need = 4 + len(payload)
        assert need + 4 <= self.page_size, \
            f"record of {len(payload)} bytes exceeds page size {self.page_size}"
        if self._used + need > self.page_size:
            self._flush_page()
        self._recs.append(payload)
        self._used += need

    def _flush_page(self):
        buf = bytearray()
        buf += struct.pack("<I", len(self._recs))
        for r in self._recs:
            buf += struct.pack("<I", len(r)) + r
        assert len(buf) <= self.page_size
        buf += b"\x00" * (self.page_size - len(buf))
        self.f.write(bytes(buf))
        self._recs = []
        self._used = 4

    def close(self):
        if self._recs:
            self._flush_page()
        self.f.close()


def read_pages(path: str):
    """Yield lists of raw records, one list per page."""
    with open(path, "rb") as f:
        head = f.read(8 + 4 + 8)
        assert head[:8] == MAGIC, f"{path}: not a CXTPUBIN file"
        version, page_size = struct.unpack("<IQ", head[8:])
        assert version == VERSION
        while True:
            page = f.read(page_size)
            if not page:
                return
            assert len(page) == page_size, f"{path}: truncated page"
            (nrec,) = struct.unpack_from("<I", page, 0)
            off = 4
            recs = []
            for _ in range(nrec):
                (ln,) = struct.unpack_from("<I", page, off)
                off += 4
                recs.append(page[off:off + ln])
                off += ln
            yield recs


def pack_imbin(list_path: str, image_root: str, out_path: str,
               page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """im2bin: pack jpegs named by a .lst file into a page file
    (reference tools/im2bin.cpp:6-67). Returns the number packed."""
    w = BinaryPageWriter(out_path, page_size)
    n = 0
    with open(list_path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 3:
                continue
            fname = toks[-1]
            with open(os.path.join(image_root, fname), "rb") as img:
                w.push(img.read())
            n += 1
    w.close()
    return n


def _decode_jpeg(buf: bytes) -> np.ndarray:
    """Decode to (c, y, x) float32 RGB (reference decodes with OpenCV)."""
    import cv2
    arr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert arr is not None, "jpeg decode failed"
    arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    return arr.transpose(2, 0, 1).astype(np.float32)


class ImageBinIterator(IIterator):
    """Paged binary reader with background page prefetch
    (iter_thread_imbin-inl.hpp:16-283)."""

    config_keys = (
        K("image_bin", "path"), K("path_imgbin", "path"),
        K("image_list", "path"), K("path_imglst", "path"),
        K("imgbin_count", "int", lo=0),
        K("shuffle", "int", lo=0, hi=1),
        K("silent", "int", lo=0, hi=1),
        K("dist_num_worker", "int", lo=1),
        K("dist_worker_rank", "int", lo=0),
        K("label_width", "int", lo=1), K("seed_data", "int"),
        K("decode_thread_num", "int", lo=0),
    )

    def __init__(self):
        self.path_imgbin = ""
        self.path_imglst = ""
        self.imgbin_count = 0  # >0: paths contain %d
        self.shuffle = 0
        self.silent = 0
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.label_width = 1
        self.seed_data = 0
        self.decode_thread_num = 0
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._pool = None
        # racelint: atomic(int swap: bumped by the consumer in before_first; the producer re-reads it to detach stale generations)
        self._gen = 0

    def set_param(self, name, val):
        if name == "image_bin" or name == "path_imgbin":
            self.path_imgbin = val
        elif name == "image_list" or name == "path_imglst":
            self.path_imglst = val
        elif name == "imgbin_count":
            self.imgbin_count = int(val)
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "seed_data":
            self.seed_data = int(val)
        elif name == "decode_thread_num":
            self.decode_thread_num = int(val)

    def init(self):
        rank = int(os.environ.get("PS_RANK", self.dist_worker_rank))
        if self.imgbin_count > 0:
            shard_ids = [i for i in range(self.imgbin_count)
                         if i % self.dist_num_worker == rank]
            self.bins = [self.path_imgbin % i for i in shard_ids]
            self.lsts = [self.path_imglst % i for i in shard_ids]
        else:
            assert self.dist_num_worker == 1, \
                "distributed sharding needs imgbin_count > 1 shards"
            self.bins = [self.path_imgbin]
            self.lsts = [self.path_imglst]
        self.labels: List[np.ndarray] = []
        self.indices: List[int] = []
        for lst in self.lsts:
            with open(lst) as f:
                for lineno, line in enumerate(f, 1):
                    toks = line.split()
                    if not toks:
                        continue  # blank line
                    if len(toks) < 3:
                        # silently skipping would desynchronize the
                        # label/record lockstep pairing for the whole shard
                        raise ValueError(
                            f"{lst} line {lineno}: expected 'index label... "
                            f"filename' (got {len(toks)} tokens)")
                    self.indices.append(int(toks[0]))
                    self.labels.append(
                        np.array([float(t) for t in
                                  toks[1:1 + self.label_width]], np.float32))
        if not self.silent:
            mlog.info(f"ImageBinIterator: {len(self.labels)} images in "
                      f"{len(self.bins)} shard(s)")

    def _page_offsets(self):
        """Global instance offset of each shard's first record (labels were
        read in shard order, so shard b's records pair with labels starting
        at offset[b])."""
        offs, pos = [], 0
        for lst in self.lsts:
            offs.append(pos)
            with open(lst) as f:
                pos += sum(1 for line in f if len(line.split()) >= 3)
        return offs

    def _producer(self, gen: int, q: "queue.Queue"):
        """Pages stream with their records' global label indices so shuffling
        permutes image and label *together* (the reference keeps labels in
        lockstep with the record stream, iter_thread_imbin_x-inl.hpp:208-233).
        Bounded puts re-check the generation so a stale producer exits
        instead of blocking on an orphaned queue."""
        shard_offsets = self._page_offsets()
        order = list(range(len(self.bins)))
        rng = None
        if self.shuffle:
            rng = np.random.RandomState(787 + self.seed_data + gen)
            rng.shuffle(order)
        for b in order:
            pos = shard_offsets[b]
            for recs in read_pages(self.bins[b]):
                idxs = list(range(pos, pos + len(recs)))
                pos += len(recs)
                if self.shuffle:
                    perm = rng.permutation(len(recs))
                    recs = [recs[j] for j in perm]
                    idxs = [idxs[j] for j in perm]
                item = list(zip(idxs, recs))
                while True:
                    if self._gen != gen:
                        return
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        while self._gen == gen:
            try:
                q.put(None, timeout=0.05)
                return
            except queue.Full:
                continue

    def before_first(self):
        self._gen = getattr(self, "_gen", 0) + 1
        if self._thread is not None:
            self._thread.join()
        self._queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(
            target=self._producer, args=(self._gen, self._queue),
            daemon=True, name="cxxnet-imbin-producer")
        self._thread.start()
        self._page = []
        self._page_pos = 0
        self._done = False

    def state(self):
        # the per-epoch shuffle is seeded ``787 + seed_data + gen``, so
        # the epoch counter IS the cross-round resume state (positions
        # rewind at each before_first; captured at a round boundary the
        # producer has exited after its None)
        return {"gen": int(self._gen)}

    def set_state(self, st):
        # retire any producer primed before resume state arrived, then
        # take the recorded epoch count, so the next epoch's shuffle order
        # matches the uninterrupted run's.  The JAX package keeps the
        # larger of the recorded and the bumped count instead, one epoch
        # too many when a membuffer rewinds to the count before its fill
        # (ROADMAP.md §C); with the producer joined, no stale one can see
        # the count go back
        self._gen += 1
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._queue = None
        self._gen = int(st.get("gen", 0))

    def close(self):
        self._gen += 1
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def next(self):
        if self._done:
            return None
        while self._page_pos >= len(self._page):
            item = self._queue.get()
            if item is None:
                self._done = True
                return None
            self._page = item
            self._page_pos = 0
            self._submit_pos = 0
        if self.decode_thread_num > 0:
            # two-stage pipeline (reference imgbinx,
            # iter_thread_imbin_x-inl.hpp:304-330): jpegs decode on a pool
            # (cv2 releases the GIL) while the consumer drains earlier
            # instances.  The submit window is bounded so decoded float32
            # arrays never accumulate page-wide ahead of the consumer.
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.decode_thread_num,
                    thread_name_prefix="cxxnet-imbin-decode")
            window = 2 * self.decode_thread_num
            while (self._submit_pos < len(self._page)
                   and self._submit_pos - self._page_pos < window):
                i = self._submit_pos
                li, buf = self._page[i]
                self._page[i] = (li, self._pool.submit(_decode_jpeg, buf))
                self._submit_pos += 1
        li, payload = self._page[self._page_pos]
        # drop the consumed entry so its decoded array is freed promptly
        self._page[self._page_pos] = None
        self._page_pos += 1
        data = payload.result() if self.decode_thread_num > 0 \
            else _decode_jpeg(payload)
        return DataInst(label=self.labels[li], data=data,
                        index=self.indices[li])


class ImageIterator(IIterator):
    """jpg-per-file list iterator (iter_img-inl.hpp:16-137)."""

    config_keys = (
        K("image_list", "path"), K("path_imglst", "path"),
        K("image_root", "path"), K("path_root", "path"),
        K("shuffle", "int", lo=0, hi=1),
        K("silent", "int", lo=0, hi=1),
        K("label_width", "int", lo=1), K("seed_data", "int"),
    )

    def __init__(self):
        self.path_imglst = ""
        self.path_root = ""
        self.shuffle = 0
        self.silent = 0
        self.label_width = 1
        self.seed_data = 0

    def set_param(self, name, val):
        if name == "image_list" or name == "path_imglst":
            self.path_imglst = val
        elif name == "image_root" or name == "path_root":
            self.path_root = val
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "seed_data":
            self.seed_data = int(val)

    def init(self):
        self.items = []
        with open(self.path_imglst) as f:
            for line in f:
                toks = line.split()
                if len(toks) < 3:
                    continue
                idx = int(toks[0])
                label = np.array(
                    [float(t) for t in toks[1:1 + self.label_width]],
                    np.float32)
                self.items.append((idx, label, toks[-1]))
        self.order = np.arange(len(self.items))
        self._epochs = 0
        if not self.silent:
            mlog.info(f"ImageIterator: {len(self.items)} images")

    def before_first(self):
        if self.shuffle:
            rng = np.random.RandomState(787 + self.seed_data)
            rng.shuffle(self.order)
            self._epochs += 1
        self._pos = 0

    def state(self):
        return {"epochs": int(getattr(self, "_epochs", 0))}

    def set_state(self, st):
        # the epoch-k order is the SAME fixed-seed permutation applied k
        # times to arange: replay it instead of storing the permutation
        # (a fresh RandomState(787 + seed_data) shuffles each epoch)
        k = int(st.get("epochs", 0))
        self.order = np.arange(len(self.items))
        for _ in range(k):
            np.random.RandomState(787 + self.seed_data).shuffle(self.order)
        self._epochs = k

    def next(self):
        if self._pos >= len(self.items):
            return None
        idx, label, fname = self.items[self.order[self._pos]]
        self._pos += 1
        with open(os.path.join(self.path_root, fname), "rb") as f:
            data = _decode_jpeg(f.read())
        return DataInst(label=label, data=data, index=idx)

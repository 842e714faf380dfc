"""Batch adaptation, augmentation, prefetch, and buffering stages (the
JAX package's ``io/iter_proc.py``: host-side numpy, the same seeds and
draws, so a chain's batches are bitwise the JAX package's).

Reference: ``src/io/iter_batch_proc-inl.hpp`` (BatchAdaptIterator +
ThreadBufferIterator), ``iter_augment_proc-inl.hpp`` (crop/mirror/mean-sub
pipeline), ``iter_mem_buffer-inl.hpp`` (DenseBufferIterator),
``iter_attach_txt-inl.hpp`` (side-feature join).  The double-buffered
producer thread mirrors utils/thread_buffer.h with a bounded queue.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import List, Optional

import numpy as np

from ..analysis.schema import K
from ..monitor import log as mlog
from .data import DataBatch, DataInst, IIterator
from .device_prefetch import ProducerError, generation_put

_AUG_RAND_MAGIC = 111


class BatchAdaptIterator(IIterator):
    """Packs DataInst into DataBatch (iter_batch_proc-inl.hpp:16-133).

    ``round_batch = 1`` wraps the epoch boundary with real instances from
    the epoch start and records ``num_batch_padd``; otherwise the tail
    partial batch is replica-padded and loss-masked (``tail_mask_padd``)
    so every real instance still trains (the reference's AdjustBatchSize
    semantics without shape polymorphism).  ``test_skipread = 1`` returns
    the same batch without reading (I/O isolation benchmark mode, :72-74).
    """

    config_keys = (
        K("batch_size", "int", lo=1),
        K("round_batch", "int", lo=0, hi=1),
        K("test_skipread", "int", lo=0, hi=1),
        K("label_width", "int", lo=1),
    )

    def __init__(self, base: IIterator):
        self.base = base
        self.batch_size = 0
        self.round_batch = 0
        self.test_skipread = 0
        self.label_width = 1
        self._head = True
        self._cached: Optional[DataBatch] = None
        self._wrap_insts: List[DataInst] = []

    def set_param(self, name, val):
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name == "test_skipread":
            self.test_skipread = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        self.base.set_param(name, val)

    def init(self):
        assert self.batch_size > 0, "batch_size must be set"
        self.base.init()

    def before_first(self):
        self._epoch_done = False
        if self.test_skipread and self._cached is not None:
            return
        self.base.before_first()

    def state(self):
        return {"epoch_done": bool(getattr(self, "_epoch_done", False)),
                "base": self.base.state()}

    def set_state(self, st):
        self._epoch_done = bool(st.get("epoch_done", False))
        if "base" in st:
            self.base.set_state(st["base"])

    def _collect(self, n: int) -> List[DataInst]:
        out = []
        while len(out) < n:
            inst = self.base.next()
            if inst is None:
                break
            out.append(inst)
        return out

    def _pack(self, insts: List[DataInst], padd: int,
              mask_padd: int = 0) -> DataBatch:
        data = np.stack([i.data for i in insts]).astype(np.float32)
        label = np.stack([np.atleast_1d(i.label)[:self.label_width]
                          for i in insts]).astype(np.float32)
        index = np.array([i.index for i in insts], np.uint32)
        return DataBatch(data=data, label=label, index=index,
                         num_batch_padd=padd, tail_mask_padd=mask_padd)

    def next(self):
        if self.test_skipread and self._cached is not None:
            return self._cached
        if getattr(self, "_epoch_done", False):
            return None
        insts = self._collect(self.batch_size)
        if len(insts) == self.batch_size:
            b = self._pack(insts, 0)
        elif not insts:
            return None
        elif self.round_batch:
            # wrap around to the beginning of the epoch; the wrapped batch is
            # the epoch's last (the rewound base must not keep feeding)
            need = self.batch_size - len(insts)
            self.base.before_first()
            wrap = self._collect(need)
            assert len(wrap) == need, "round_batch: dataset smaller than batch"
            b = self._pack(insts + wrap, need)
            self._epoch_done = True
        else:
            # short tail: pad with replicas of the last instance and mask
            # them out of training/eval, so every real instance still
            # trains (the reference's AdjustBatchSize trains the tail by
            # re-plumbing shapes, neural_net-inl.hpp:266-277; the JAX
            # package's step is shape-static, so pad + loss-mask, and the
            # port keeps its batches)
            need = self.batch_size - len(insts)
            b = self._pack(insts + [insts[-1]] * need, need, mask_padd=need)
        if self.test_skipread:
            self._cached = b
        return b


class AffineAugmenter:
    """Geometric augmentation via one warpAffine per instance (reference
    ``image_augmenter-inl.hpp:13-204``): random rotation (range or explicit
    ``rotate_list``), shear, aspect-ratio jitter, and a random square crop
    of side in [min_crop_size, max_crop_size] resized back to the target
    shape.  Skipped entirely when no geometric param is set (NeedProcess,
    :156-161)."""

    def __init__(self):
        self.rotate = -1.0           # fixed angle; -1 = off
        self.max_rotate_angle = 0.0
        self.max_shear_ratio = 0.0
        self.max_aspect_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.rotate_list: List[float] = []
        self.fill_value = 0.0

    def set_param(self, name, val) -> bool:
        if name == "rotate":
            self.rotate = float(val)
        elif name == "max_rotate_angle":
            self.max_rotate_angle = float(val)
        elif name == "max_shear_ratio":
            self.max_shear_ratio = float(val)
        elif name == "max_aspect_ratio":
            self.max_aspect_ratio = float(val)
        elif name == "min_crop_size":
            self.min_crop_size = int(val)
        elif name == "max_crop_size":
            self.max_crop_size = int(val)
        elif name == "rotate_list":
            self.rotate_list = [float(t) for t in val.split(",") if t.strip()]
        elif name == "fill_value":
            self.fill_value = float(val)
        else:
            return False
        return True

    @property
    def need_process(self) -> bool:
        return (self.rotate >= 0 or self.max_rotate_angle > 0
                or self.max_shear_ratio > 0 or self.max_aspect_ratio > 0
                or bool(self.rotate_list)
                or (self.min_crop_size > 0 and self.max_crop_size > 0))

    def process(self, d: np.ndarray, rnd: np.random.RandomState,
                target_yx) -> np.ndarray:
        """d is (c, y, x) float32; returns (c, ty, tx) when cropping, else
        the warped image at its original size."""
        import cv2
        img = d.transpose(1, 2, 0)  # HWC for cv
        h, w = img.shape[:2]
        if self.rotate >= 0:
            angle = self.rotate
        elif self.rotate_list:
            angle = self.rotate_list[rnd.randint(len(self.rotate_list))]
        else:
            a = self.max_rotate_angle
            angle = rnd.uniform(-a, a) if a > 0 else 0.0
        shear = rnd.uniform(-self.max_shear_ratio, self.max_shear_ratio) \
            if self.max_shear_ratio > 0 else 0.0
        if self.max_aspect_ratio > 0:
            ratio = 1.0 + rnd.uniform(0, self.max_aspect_ratio)
            if rnd.rand() < 0.5:
                ratio = 1.0 / ratio
            sx, sy = np.sqrt(ratio), 1.0 / np.sqrt(ratio)
        else:
            sx = sy = 1.0
        if angle != 0.0 or shear != 0.0 or sx != 1.0:
            rad = np.deg2rad(angle)
            cos, sin = np.cos(rad), np.sin(rad)
            # rotation @ shear @ aspect-scale, centered on the image
            lin = np.array([[cos, -sin], [sin, cos]], np.float64) \
                @ np.array([[1.0, shear], [0.0, 1.0]], np.float64) \
                @ np.diag([sx, sy])
            c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
            m = np.hstack([lin, (c - lin @ c).reshape(2, 1)])
            img = cv2.warpAffine(
                img, m, (w, h), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT,
                borderValue=[self.fill_value] * img.shape[2])
        if self.min_crop_size > 0 and self.max_crop_size > 0:
            assert self.min_crop_size <= min(self.max_crop_size, h, w), \
                (f"augment: min_crop_size={self.min_crop_size} exceeds "
                 f"max_crop_size={self.max_crop_size} or image size {h}x{w}")
            cs = rnd.randint(self.min_crop_size,
                             min(self.max_crop_size, h, w) + 1)
            y0 = rnd.randint(0, max(h - cs, 0) + 1)
            x0 = rnd.randint(0, max(w - cs, 0) + 1)
            patch = img[y0:y0 + cs, x0:x0 + cs]
            ty, tx = target_yx
            img = cv2.resize(patch, (tx, ty), interpolation=cv2.INTER_LINEAR)
        if img.ndim == 2:
            img = img[:, :, None]
        return np.ascontiguousarray(img.transpose(2, 0, 1), np.float32)


class AugmentIterator(IIterator):
    """Per-instance augmentation (iter_augment_proc-inl.hpp:21-246):
    cv-affine stage (rotation/shear/aspect/crop-size, see AffineAugmenter),
    random/fixed crop, mirror, mean subtraction (mean image file generated on
    first use, :171-198, or mean_value RGB), scale."""

    config_keys = (
        K("rotate", "float"), K("max_rotate_angle", "float", lo=0),
        K("max_shear_ratio", "float", lo=0),
        K("max_aspect_ratio", "float", lo=0),
        K("min_crop_size", "int", lo=0),
        K("max_crop_size", "int", lo=0),
        K("rotate_list", "str", help="comma-separated angles"),
        K("fill_value", "float"),
        K("rand_crop", "int", lo=0, hi=1),
        K("rand_mirror", "int", lo=0, hi=1),
        K("mirror", "int", lo=0, hi=1),
        K("input_shape", "str", help="c,y,x"),
        K("image_mean", "path"), K("mean_value", "str"),
        K("scale", "float"),
        K("max_random_contrast", "float", lo=0),
        K("max_random_illumination", "float", lo=0),
        K("crop_y_start", "int", lo=0), K("crop_x_start", "int", lo=0),
    )

    def __init__(self, base: IIterator):
        self.base = base
        self.rand_crop = 0
        self.rand_mirror = 0
        self.mirror = 0
        self.input_shape = None  # (c, y, x)
        self.mean_file = ""
        self.mean_value: Optional[np.ndarray] = None
        self.scale = 1.0
        self.max_random_contrast = 0.0
        self.max_random_illumination = 0.0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.affine = AffineAugmenter()
        self.rnd = np.random.RandomState(_AUG_RAND_MAGIC)
        self._mean: Optional[np.ndarray] = None
        self._warned_mean_fallback = False

    def set_param(self, name, val):
        if self.affine.set_param(name, val):
            pass
        elif name == "rand_crop":
            self.rand_crop = int(val)
        elif name == "rand_mirror":
            self.rand_mirror = int(val)
        elif name == "mirror":
            self.mirror = int(val)
        elif name == "input_shape":
            self.input_shape = tuple(int(t) for t in val.split(","))
        elif name == "image_mean":
            self.mean_file = val
        elif name == "mean_value":
            self.mean_value = np.array(
                [float(t) for t in val.split(",")], np.float32)
        elif name == "scale":
            self.scale = float(val)
        elif name == "max_random_contrast":
            self.max_random_contrast = float(val)
        elif name == "max_random_illumination":
            self.max_random_illumination = float(val)
        elif name == "crop_y_start":
            self.crop_y_start = int(val)
        elif name == "crop_x_start":
            self.crop_x_start = int(val)
        self.base.set_param(name, val)

    def init(self):
        self.base.init()
        if self.mean_file:
            if os.path.exists(self.mean_file):
                self._mean = np.load(self.mean_file)["mean"]
            else:
                self._create_mean_img()

    def _create_mean_img(self):
        """Average all instances into a mean image (CreateMeanImg parity)."""
        self.base.before_first()
        acc = None
        n = 0
        while True:
            inst = self.base.next()
            if inst is None:
                break
            if acc is None:
                acc = inst.data.astype(np.float64)
            else:
                acc += inst.data
            n += 1
        assert n > 0, "augment: empty dataset, cannot build mean image"
        self._mean = (acc / n).astype(np.float32)
        np.savez(self.mean_file, mean=self._mean)
        mlog.info(f"AugmentIterator: saved mean image to {self.mean_file}")

    def before_first(self):
        self.base.before_first()

    def state(self):
        # the augment rng advances ACROSS epochs — the one piece of
        # cross-round iterator state an exact resume must restore (a
        # positional rewind alone would replay round 1's crops/mirrors)
        name, keys, pos, has_gauss, cached = self.rnd.get_state()
        return {"rnd": [name, np.asarray(keys).tolist(), int(pos),
                        int(has_gauss), float(cached)],
                "base": self.base.state()}

    def set_state(self, st):
        if "rnd" in st:
            name, keys, pos, has_gauss, cached = st["rnd"]
            self.rnd.set_state((name, np.asarray(keys, np.uint32),
                                int(pos), int(has_gauss), float(cached)))
        if "base" in st:
            self.base.set_state(st["base"])

    def next(self):
        inst = self.base.next()
        if inst is None:
            return None
        d = inst.data.astype(np.float32)
        if self.affine.need_process:
            target = self.input_shape[1:] if self.input_shape is not None \
                else d.shape[1:]
            d = self.affine.process(d, self.rnd, target)
        if self._mean is not None:
            m = self._mean
            if m.shape != d.shape:
                my, mx = m.shape[1], m.shape[2]
                dy, dx = d.shape[1], d.shape[2]
                if my >= dy and mx >= dx:
                    y0, x0 = (my - dy) // 2, (mx - dx) // 2
                    m = m[:, y0:y0 + dy, x0:x0 + dx]
                else:  # affine resized past the mean image: channel means
                    if not self._warned_mean_fallback:
                        self._warned_mean_fallback = True
                        mlog.warn(
                            f"AugmentIterator: mean image {m.shape} "
                            f"smaller than instance {d.shape}; falling "
                            "back to per-channel scalar means")
                    m = m.mean(axis=(1, 2), keepdims=True)
            d = d - m
        elif self.mean_value is not None:
            d = d - self.mean_value.reshape(-1, 1, 1)
        if self.max_random_contrast > 0:
            c = 1.0 + (self.rnd.rand() * 2 - 1) * self.max_random_contrast
            d = d * c
        if self.max_random_illumination > 0:
            d = d + (self.rnd.rand() * 2 - 1) * self.max_random_illumination
        if self.input_shape is not None and self.input_shape[1:] != d.shape[1:]:
            cy, cx = self.input_shape[1], self.input_shape[2]
            assert d.shape[1] >= cy and d.shape[2] >= cx, \
                f"augment: crop {cy}x{cx} larger than input {d.shape}"
            if self.rand_crop:
                y0 = self.rnd.randint(0, d.shape[1] - cy + 1)
                x0 = self.rnd.randint(0, d.shape[2] - cx + 1)
            else:
                y0 = self.crop_y_start if self.crop_y_start >= 0 \
                    else (d.shape[1] - cy) // 2
                x0 = self.crop_x_start if self.crop_x_start >= 0 \
                    else (d.shape[2] - cx) // 2
            d = d[:, y0:y0 + cy, x0:x0 + cx]
        if self.mirror or (self.rand_mirror and self.rnd.rand() < 0.5):
            d = d[:, :, ::-1].copy()
        if self.scale != 1.0:
            d = d * self.scale
        return DataInst(label=inst.label, data=d, index=inst.index)


class ThreadBufferIterator(IIterator):
    """Batch-level prefetch on a producer thread
    (iter_batch_proc-inl.hpp:136-224 over utils/thread_buffer.h).

    Each epoch gets its own queue + producer thread; a generation counter
    poisons stale producers, and before_first() joins the previous producer
    before rewinding the (shared) base iterator, so exactly one thread ever
    touches the base.  A producer exception is enqueued and re-raised in
    the consumer's next() — the epoch is dead until the next
    before_first(), never a hang.

    ``init()`` rewinds the base as the JAX package's priming does, but the
    producer starts at the first ``next()`` (or ``before_first()``): the
    JAX package starts one at ``init()``, and the first ``before_first()``
    retires it after as many pulls as it made by then, which stages with
    state across epochs (the augment rng, packseq's carried tokens, a
    membuffer's fill) keep; the first epoch then depends on timing
    (ROADMAP.md §C).
    """

    config_keys = (K("buffer_size", "int", lo=1),)

    def __init__(self, base: IIterator, max_buffer: int = 4):
        self.base = base
        self.max_buffer = max_buffer
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._gen = 0
        self._failed: Optional[BaseException] = None
        # the epoch init() rewound, its producer not started yet
        self._rewound = False

    def set_param(self, name, val):
        if name == "buffer_size":
            self.max_buffer = max(1, int(val))
        self.base.set_param(name, val)

    def init(self):
        self.base.init()
        # next() works straight after init(), like every other iterator's
        # (the reference's ThreadBuffer starts its thread at Init,
        # thread_buffer.h:30-38): the base is rewound here, its producer
        # started by that first next()
        self.base.before_first()
        self._rewound = True

    def _producer(self, gen: int, q: "queue.Queue"):
        while True:
            try:
                b = self.base.next()
            except BaseException as e:  # noqa: BLE001 — reach the consumer
                b = ProducerError(e)
            if not generation_put(self, gen, q, b):
                return
            if b is None or isinstance(b, ProducerError):
                return

    def before_first(self):
        self._gen += 1
        self._failed = None
        self._rewound = False
        if self._thread is not None:
            self._thread.join()  # unblocks via the generation check
        self.base.before_first()
        self._start()

    def _start(self):
        q = queue.Queue(maxsize=self.max_buffer)
        self._queue = q
        self._thread = threading.Thread(
            target=self._producer, args=(self._gen, q),
            daemon=True, name="cxxnet-io-buffer-producer")
        self._thread.start()

    def next(self):
        if self._rewound:
            self._rewound = False
            self._start()
        assert self._queue is not None, "call before_first() first"
        if self._failed is not None:
            raise self._failed  # epoch is dead; rewind with before_first()
        v = self._queue.get()
        if isinstance(v, ProducerError):
            self._failed = v.exc
            raise v.exc
        return v

    def set_state(self, st):
        # quiesce any producer BEFORE touching the shared base; the next
        # before_first() rewinds and restarts as usual, with the base's
        # cross-epoch state (augment rng, cache fill) restored
        self._rewound = False
        self._gen += 1
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._queue = None
        if "base" in st:
            self.base.set_state(st["base"])

    def close(self):
        self._gen += 1
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.base.close()


class DenseBufferIterator(IIterator):
    """Caches the first max_nbatch batches in RAM and loops over them
    (iter_mem_buffer-inl.hpp:16-76)."""

    config_keys = (K("max_nbatch", "int", lo=1),)

    def __init__(self, base: IIterator):
        self.base = base
        self.max_nbatch = 0
        self._cache: List[DataBatch] = []
        self._filled = False
        self._pos = 0
        self._prefill_base = None

    def set_param(self, name, val):
        if name == "max_nbatch":
            self.max_nbatch = int(val)
        self.base.set_param(name, val)

    def init(self):
        assert self.max_nbatch > 0, "membuffer: set max_nbatch"
        self.base.init()

    def before_first(self):
        self._pos = 0
        if not self._filled:
            # a stage above may have pulled a partial fill through us
            # before the first real epoch; rewinding the base under that
            # partial cache would pair each remaining item with the wrong
            # rng draw — drop it and restart the fill cleanly
            self._cache = []
            # the base's state at the instant the fill starts: a resumed
            # run rewinds to it before rebuilding the cache, so the
            # rebuild replays the ORIGINAL fill's rng draws
            self._prefill_base = self.base.state()
            self.base.before_first()

    def state(self):
        st = {"filled": bool(self._filled), "pos": int(self._pos),
              "base": self.base.state()}
        if self._prefill_base is not None:
            st["prefill_base"] = self._prefill_base
        return st

    def set_state(self, st):
        if st.get("prefill_base") is not None:
            self._prefill_base = st["prefill_base"]
        if st.get("filled") and not self._filled:
            # rebuild the cache deterministically (the original fill read
            # the base's first max_nbatch batches; after the fill the
            # base is never read again).  A stage above may already have
            # pulled through us before resume state arrived: drop those
            # pulls and rewind the base to its recorded pre-fill state so
            # the rebuild reproduces the original cache — same batches,
            # same augment rng draws
            self._cache = []
            self._pos = 0
            if self._prefill_base is not None:
                self.base.set_state(self._prefill_base)
            self.base.before_first()
            while not self._filled and self.next() is not None:
                pass
            self._filled = True
        self._pos = int(st.get("pos", 0))
        if "base" in st:
            self.base.set_state(st["base"])

    def next(self):
        if self._filled:
            if self._pos >= len(self._cache):
                return None
            b = self._cache[self._pos]
            self._pos += 1
            return b
        if len(self._cache) >= self.max_nbatch:
            self._filled = True
            return None
        b = self.base.next()
        if b is None:
            self._filled = True
            return None
        self._cache.append(b)
        self._pos = len(self._cache)
        return b


class AttachTxtIterator(IIterator):
    """Joins per-instance side features from a text file into
    ``batch.extra_data``, keyed by instance index
    (iter_attach_txt-inl.hpp:15-99).  File format: each line is
    ``inst_index v1 v2 ... vk``; shape from ``extra_shape[i] = c,y,x``."""

    config_keys = (
        K("path_attach_txt", "path"), K("path_txt", "path"),
        K("extra_data_shape[*]", "str", help="c,y,x per side input"),
    )

    def __init__(self, base: IIterator):
        self.base = base
        self.path_txt = ""
        self.extra_shapes: List[tuple] = []
        self._table = {}

    def set_param(self, name, val):
        import re
        if name == "path_attach_txt" or name == "path_txt":
            self.path_txt = val
        m = re.match(r"^extra_data_shape\[(\d+)\]$", name)
        if m:
            idx = int(m.group(1))
            shape = tuple(int(t) for t in val.split(","))
            while len(self.extra_shapes) <= idx:
                self.extra_shapes.append(None)
            self.extra_shapes[idx] = shape
        self.base.set_param(name, val)

    def init(self):
        self.base.init()
        assert self.path_txt, "attachtxt: set path_attach_txt"
        with open(self.path_txt) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                self._table[int(toks[0])] = np.array(
                    [float(t) for t in toks[1:]], np.float32)

    def before_first(self):
        self.base.before_first()

    def next(self):
        b = self.base.next()
        if b is None:
            return None
        feats = np.stack([self._table[int(i)] for i in b.index])
        extra = []
        if self.extra_shapes and self.extra_shapes[0] is not None:
            off = 0
            for shape in self.extra_shapes:
                size = int(np.prod(shape))
                extra.append(feats[:, off:off + size]
                             .reshape((len(feats),) + shape))
                off += size
        else:
            extra.append(feats.reshape(len(feats), 1, 1, -1))
        b.extra_data = extra
        return b


def s2d_np(x: np.ndarray, s: int, kh: int, kw: int, oh: int, ow: int,
           pad_y: int, pad_x: int) -> np.ndarray:
    """Numpy mirror of ops.nn.s2d_input: (n, c, h, w) -> the input_s2d
    delivery shape (n, c*s*s, hb, wb), channel order (c, sy, sx).
    Dtype-preserving (u8 stays u8 — a pure permutation)."""
    from ..ops.nn import s2d_staged_shape
    n, c, h, w = x.shape
    c2, hb, wb = s2d_staged_shape(c, s, kh, kw, oh, ow)
    xp = np.pad(x, ((0, 0), (0, 0),
                    (pad_y, max(0, hb * s - h - pad_y)),
                    (pad_x, max(0, wb * s - w - pad_x))))
    xp = xp[:, :, :hb * s, :wb * s]
    xb = xp.reshape(n, c, hb, s, wb, s)
    return np.ascontiguousarray(
        xb.transpose(0, 1, 3, 5, 2, 4)).reshape(n, c2, hb, wb)


class S2DEmitIterator(IIterator):
    """Host-side space-to-depth emission (the ``input_s2d`` pipeline
    contract): transform each batch on the host, on the producer thread
    of a buffering stage, so the trainer's staging transform
    (``NetTrainer.stage_input``) passes it through.  Wraps any
    assembled-batch iterator; installed by the CLI (``main.py``
    ``_wrap_s2d``) when the trainer reports an s2d geometry.

    u8 batches through a PADDED first conv are passed through
    untransformed (u8 cannot encode the normalized zero padding; the
    trainer's device path normalizes before padding instead)."""

    def __init__(self, base: IIterator, s2d_args):
        self.base = base
        (self.s, self.kh, self.kw, self.oh, self.ow,
         self.pad_y, self.pad_x) = s2d_args

    def set_param(self, name: str, val: str) -> None:
        self.base.set_param(name, val)

    def init(self) -> None:
        self.base.init()

    def before_first(self) -> None:
        self.base.before_first()

    def next(self):
        b = self.base.next()
        if b is None:
            return None
        if b.data.dtype == np.uint8 and (self.pad_y or self.pad_x):
            return b  # device path handles (normalize-then-pad)
        data = s2d_np(np.asarray(b.data), self.s, self.kh, self.kw,
                      self.oh, self.ow, self.pad_y, self.pad_x)
        return dataclasses.replace(b, data=data)

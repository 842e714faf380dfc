"""ctypes binding of the native (C++) data loader, ``iter = imbin_native``
(the JAX package's ``io/native.py``, with a build of its own).

The loader is ``native/imbin_iter.cc`` (paged pack reading, a producer
thread, libjpeg decode, mean / scale and batch assembly in C++; raw u8
and float32 records are copied without a decoder).  :func:`load_library`
compiles it at first use with ``g++ ... -shared -ljpeg`` into the
git-ignored ``cxxnet_tpu_torch/ops/_build/``, named by a hash of the
sources and flags, under a file lock so that concurrent processes build
it once.  Nothing is built at import.  A failed build raises with the
compiler's message: there is no fallback to ``iter = imgbin``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..analysis.schema import K
from .data import DataBatch, IIterator

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO_ROOT / "native"
SOURCES = ("imbin_iter.cc", "binpage.h", "config.h", "thread_buffer.h")
BUILD_DIR = _REPO_ROOT / "cxxnet_tpu_torch" / "ops" / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread")
LDLIBS = ("-ljpeg",)


class NativeCompileError(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    for name in SOURCES:
        h.update(name.encode() + (NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libcxxnet_native_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the loader unless the current build exists; returns its
    path.  Concurrent callers (threads or processes) wait on one file
    lock, and the library appears by an atomic rename."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # disclint: ok(atomic-write) — an empty lock file, never read
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXXFLAGS, "-shared", "-o", str(tmp),
               str(NATIVE_DIR / "imbin_iter.cc"), *LDLIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeCompileError(
                f"cannot run g++ ({e}): the native loader builds from "
                "native/imbin_iter.cc") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeCompileError(
                f"building the native loader failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """dlopen the native loader, building it on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        lib.CXNIONativeCreate.restype = ctypes.c_void_p
        lib.CXNIONativeCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.CXNIONativeBeforeFirst.argtypes = [ctypes.c_void_p]
        lib.CXNIONativeNextBatch.restype = ctypes.c_int
        lib.CXNIONativeNextBatch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)]
        lib.CXNIONativeShape.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.CXNIONativeNextBatchU8.restype = ctypes.c_int
        lib.CXNIONativeNextBatchU8.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)]
        lib.CXNIONativeIsU8.restype = ctypes.c_int
        lib.CXNIONativeIsU8.argtypes = [ctypes.c_void_p]
        lib.CXNIONativeLastError.restype = ctypes.c_char_p
        lib.CXNIONativeLastError.argtypes = [ctypes.c_void_p]
        lib.CXNIONativeFree.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeImageBinIterator(IIterator):
    """Batch iterator backed by the C++ paged loader.

    Unlike the Python ``imgbin`` chain (base -> augment -> batch adapter),
    this produces finished batches directly: mean / scale normalization
    and round_batch / num_batch_padd handling happen in C++ (reference
    batch adapter semantics, iter_batch_proc-inl.hpp:89-106); under
    ``output_u8 = 1`` the batches are raw u8 and the trainer normalises
    them on the device (``scale``, ``mean_value``).
    """

    config_keys = (
        K("image_bin", "path"), K("path_imgbin", "path"),
        K("image_list", "path"), K("path_imglst", "path"),
        K("batch_size", "int", lo=1),
        K("round_batch", "int", lo=0, hi=1),
        K("label_width", "int", lo=1),
        K("shuffle", "int", lo=0, hi=1),
        K("silent", "int", lo=0, hi=1), K("seed_data", "int"),
        K("input_shape", "str", help="c,y,x"),
        K("image_mean", "path"), K("mean_value", "str"),
        K("scale", "float"), K("output_u8", "int", lo=0, hi=1),
        K("rand_crop", "int", lo=0, hi=1),
        K("rand_mirror", "int", lo=0, hi=1),
        K("mirror", "int", lo=0, hi=1),
        K("decode_thread_num", "int", lo=0),
    )

    def __init__(self):
        self._cfg = []
        self._h: Optional[int] = None
        self._lib = None
        self._round_batch = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "round_batch":
            self._round_batch = int(val)
        self._cfg.append((name, val))

    def init(self) -> None:
        self._lib = load_library()
        cfg_text = "\n".join(f"{k} = {v}" for k, v in self._cfg)
        err = ctypes.create_string_buffer(4096)
        h = self._lib.CXNIONativeCreate(cfg_text.encode(), err, len(err))
        if not h:
            raise RuntimeError(
                f"native iterator init failed: {err.value.decode()}")
        self._h = h
        shp = (ctypes.c_longlong * 6)()
        self._lib.CXNIONativeShape(self._h, shp)
        (self.batch_size, self.c, self.h, self.w,
         self.label_width, self.num_inst) = [int(x) for x in shp]

    def before_first(self) -> None:
        assert self._h is not None, "init() must be called first"
        self._lib.CXNIONativeBeforeFirst(self._h)

    def state(self):
        # the shuffle / cursor state lives C++-side with no capture API:
        # raising (instead of the silent {} default) makes the
        # checkpoint path warn that this iterator resumes cold
        raise NotImplementedError(
            "native iterator state lives in C++; resume restarts it cold")

    def set_state(self, st):
        raise NotImplementedError(
            "native iterator state lives in C++; resume restarts it cold")

    def next(self) -> Optional[DataBatch]:
        u8 = bool(self._lib.CXNIONativeIsU8(self._h))
        label = np.empty((self.batch_size, self.label_width), np.float32)
        index = np.empty((self.batch_size,), np.uint64)
        padd = ctypes.c_uint32(0)
        data = np.empty((self.batch_size, self.c, self.h, self.w),
                        np.uint8 if u8 else np.float32)
        fn = (self._lib.CXNIONativeNextBatchU8 if u8
              else self._lib.CXNIONativeNextBatch)
        got = fn(self._h,
                 data.ctypes.data_as(ctypes.POINTER(
                     ctypes.c_ubyte if u8 else ctypes.c_float)),
                 label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                 ctypes.byref(padd))
        if not got:
            err = self._lib.CXNIONativeLastError(self._h)
            if err:
                raise RuntimeError(f"native iterator: {err.decode()}")
            return None
        # without round_batch, trailing padding is replica padding of the
        # tail (C++ side pads with the last instance): masked out of
        # training; round_batch wrap rows are real data and train unmasked
        return DataBatch(data=data, label=label,
                         index=index.astype(np.uint32),
                         num_batch_padd=int(padd.value),
                         tail_mask_padd=0 if self._round_batch
                         else int(padd.value))

    def close(self) -> None:
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.CXNIONativeFree(self._h)
            self._h = None

    def __del__(self):
        self.close()

"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` compiles each in seconds.  At first use every source is
compiled to an object file, all ``nvcc`` processes started together,
then linked into one shared library for ``sm_90a`` inside
``ops/_build/`` (ignored by git), named by a hash of the sources and
flags so an edited source rebuilds.  The library is loaded with
``ctypes``; each wrapper passes device pointers and the current CUDA
stream as integers and raises when the C entry point returns a
non-zero ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: devices whose tensors every kernel wrapper sends to its plain version:
#: the CPU, and ``meta`` (shapes without storage: ``task = check``'s
#: traced graph, analysis/graph_lint.py).  A CUDA tensor launches the
#: kernel or raises; any other device raises.
PLAIN_DEVICES = ("cpu", "meta")

#: dtype codes of the C entry points (csrc/common.cuh CxnDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c = ctypes
_SIGNATURES = {
    # q, k, v, seg, o, lse, bh, h, s, d, causal, scale, dtype, stream
    "cxn_flash_attn_fwd": (_c.c_void_p,) * 6 + (_c.c_int,) * 5
    + (_c.c_float, _c.c_int, _c.c_void_p),
    # q, k, v, seg, o, lse, dout, delta, dq, dk, dv, bh, h, s, d, causal,
    # scale, dtype, stream
    "cxn_flash_attn_bwd": (_c.c_void_p,) * 11 + (_c.c_int,) * 5
    + (_c.c_float, _c.c_int, _c.c_void_p),
    # d, dtype, backward
    "cxn_flash_attn_route": (_c.c_int,) * 3,
    # x, gamma, beta, y, mean, rstd, rows, d, eps, xdtype, gdtype, stream
    "cxn_layernorm_fwd": (_c.c_void_p,) * 6 + (_c.c_longlong, _c.c_int,
                                               _c.c_float, _c.c_int,
                                               _c.c_int, _c.c_void_p),
    # d
    "cxn_layernorm_fwd_route": (_c.c_int,),
    # a, gamma, beta, mean, rstd, dy, dx, scratch, dg, db, rows, d, route,
    # vec, el, wpr, blocks, save_x, xdtype, gdtype, stream
    "cxn_layernorm_bwd": (_c.c_void_p,) * 10 + (_c.c_longlong,)
    + (_c.c_int,) * 9 + (_c.c_void_p,),
    # backward, x, g, out, outer, c, inner, nsize, salpha, beta, knorm,
    # route, vec, chunk, dtype, stream
    "cxn_lrn": (_c.c_int,) + (_c.c_void_p,) * 3 + (_c.c_longlong, _c.c_int,
                                                   _c.c_longlong, _c.c_int)
    + (_c.c_float,) * 3 + (_c.c_int,) * 4 + (_c.c_void_p,),
    # backward, relu, x, y, dy, out, planes, h, w, oh, ow, kh, kw, s,
    # pad_y, pad_x, cells, group, dtype, stream
    "cxn_max_pool": (_c.c_int,) * 2 + (_c.c_void_p,) * 4 + (_c.c_longlong,)
    + (_c.c_int,) * 12 + (_c.c_void_p,),
    # c, co, ow, kh, kw, s, dtype
    "cxn_conv_wgrad_route": (_c.c_int,) * 7,
    # x, dy, part, part_b, dw, db, n, c, h, w, co, oh, ow, kh, kw, s,
    # pad_y, pad_x, splits, per_split, dtype, stream
    "cxn_conv_wgrad": (_c.c_void_p,) * 6 + (_c.c_int,) * 13
    + (_c.c_longlong, _c.c_int, _c.c_void_p),
    # g, m1, m2, w32, p, n, lr_t, d1, d2, wd, clip, stream
    "cxn_fused_adam": (_c.c_void_p,) * 5 + (_c.c_longlong,)
    + (_c.c_float,) * 5 + (_c.c_void_p,),
}


class KernelCompileError(RuntimeError):
    pass


class _Library:
    """The process's one copy of the built kernel library."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_sec = 0.0    # 0 when an up-to-date library was reused
        self.build_log = ""     # nvcc output (-Xptxas -v register counts)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> Path:
        sources = sorted(SRC_DIR.glob("*.cu"))
        h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        for p in sorted(SRC_DIR.iterdir()):
            h.update(p.name.encode() + p.read_bytes())
        out = BUILD_DIR / f"libcxxnet_kernels_{h.hexdigest()[:16]}.so"
        if out.exists():
            return out
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tag = f"{os.getpid()}_{threading.get_ident()}"
        objs = [BUILD_DIR / f"{p.stem}_{tag}.o" for p in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c",
             str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        self.build_log = "\n".join(logs)
        if failed:
            raise KernelCompileError(
                f"nvcc failed on {', '.join(failed)}:\n{self.build_log}")
        tmp = out.with_suffix(f".{tag}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)]
            + [str(o) for o in objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for o in objs:
            o.unlink()
        if link.returncode != 0:
            raise KernelCompileError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)
        self.build_sec = time.perf_counter() - t0
        return out

    @staticmethod
    def _load(path: Path) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelCompileError(
        "nvcc not found (not on PATH, no /usr/local/cuda/bin/nvcc): the "
        "CUDA kernels build from ops/csrc at first use on the GPU")


LIBRARY = _Library()


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

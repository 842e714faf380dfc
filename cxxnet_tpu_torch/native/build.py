"""Build the port's C ABI (``capi.cc``), its C demo and its trainer binary.

``capi.cc`` implements ``native/capi.h`` over
:mod:`cxxnet_tpu_torch.wrapper.api` by embedding CPython.  The trainer
binary is ``native/cxxnet_main.cc``, which calls only ``capi.h``,
linked against the port's library.  At first use the three are compiled
with the host C++ compiler (``g++``, ``gcc`` for the demo) and the
flags of the running interpreter's ``python3-config`` (or, without that
script, of its ``sysconfig``) into the git-ignored
``cxxnet_tpu_torch/native/_build/``, named by a hash of the sources and
flags, under a file lock so that concurrent processes (test workers)
build once; each output appears by an atomic rename.  Nothing lands in
``native/`` and nothing is built at import.  A failed build raises with
the compiler's message.

    python -m cxxnet_tpu_torch.native.build     # prints the three paths
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Dict, List, Sequence

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
HEADER_DIR = REPO / "native"
BUILD_DIR = HERE / "_build"
SOURCES = (HERE / "capi.cc", HERE / "capi_demo.c",
           HEADER_DIR / "cxxnet_main.cc", HEADER_DIR / "capi.h")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread")


class CapiBuildError(RuntimeError):
    pass


def python_config() -> str:
    """The ``python3-config`` of the running interpreter's installation
    (a virtual environment's base install), else the first on PATH, else
    ``""``."""
    ver = sysconfig.get_config_var("VERSION") or ""
    for name in (f"python{ver}-config", "python3-config"):
        cand = Path(sys.base_prefix) / "bin" / name
        if cand.exists():
            return str(cand)
    return shutil.which("python3-config") or ""


def _sysconfig_flags() -> Dict[str, List[str]]:
    """The flags ``python3-config --includes`` / ``--ldflags --embed``
    print, read from the interpreter's own ``sysconfig`` (an install
    without the script)."""
    ver = sysconfig.get_config_var("VERSION")
    libs = (sysconfig.get_config_var("LIBS") or "").split()
    return {"includes": [f"-I{sysconfig.get_paths()['include']}"],
            "ldflags": [f"-lpython{ver}"] + libs}


def _py_flags() -> Dict[str, List[str]]:
    cfg = python_config()
    if not cfg:
        flags = _sysconfig_flags()
        libdir = sysconfig.get_config_var("LIBDIR")
        if libdir:
            flags["ldflags"] = [f"-L{libdir}", f"-Wl,-rpath,{libdir}"] \
                + flags["ldflags"]
        return flags

    def run(*args) -> List[str]:
        r = subprocess.run([cfg, *args], capture_output=True, text=True)
        if r.returncode != 0:
            raise CapiBuildError(f"{cfg} {' '.join(args)} failed: "
                                 f"{r.stderr}")
        return r.stdout.split()

    try:
        ld = run("--ldflags", "--embed")
    except CapiBuildError:
        ld = run("--ldflags")
    libdir = sysconfig.get_config_var("LIBDIR")
    if libdir:
        ld = [f"-L{libdir}", f"-Wl,-rpath,{libdir}"] + ld
    return {"includes": run("--includes"), "ldflags": ld}


def _digest(flags: Dict[str, List[str]]) -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + tuple(flags["includes"])
                                + tuple(flags["ldflags"])).encode())
    for path in SOURCES:
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def outputs(flags: Dict[str, List[str]] = None) -> Dict[str, Path]:
    """Where the builds of the current sources and flags live."""
    tag = _digest(_py_flags() if flags is None else flags)
    return {"lib": BUILD_DIR / f"libcxxnet_torch_capi_{tag}.so",
            "demo": BUILD_DIR / f"capi_demo_{tag}",
            "cxxnet": BUILD_DIR / f"cxxnet_{tag}"}


def _compile(cmd: Sequence[str], out: Path) -> None:
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = [str(c) for c in cmd] + ["-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise CapiBuildError(f"cannot run {cmd[0]} ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CapiBuildError(f"building {out.name} failed "
                             f"({' '.join(cmd)}):\n{proc.stdout}"
                             f"{proc.stderr}")
    os.replace(tmp, out)


def build() -> Dict[str, Path]:
    """Compile the C ABI library, the demo and the trainer binary unless
    the current builds exist; returns their paths."""
    flags = _py_flags()
    out = outputs(flags)
    if all(p.exists() for p in out.values()):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # disclint: ok(atomic-write) — an empty lock file, never read
    with open(BUILD_DIR / "capi.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        inc = [f"-I{HEADER_DIR}"]
        if not out["lib"].exists():
            _compile(["g++", *CXXFLAGS, *flags["includes"], *inc, "-shared",
                      HERE / "capi.cc", *flags["ldflags"]], out["lib"])
        link = [f"-L{BUILD_DIR}", f"-l:{out['lib'].name}",
                "-Wl,-rpath,$ORIGIN"]
        if not out["demo"].exists():
            _compile(["gcc", "-O2", "-Wall", *inc, HERE / "capi_demo.c",
                      *link], out["demo"])
        if not out["cxxnet"].exists():
            _compile(["g++", *CXXFLAGS, *inc, HEADER_DIR / "cxxnet_main.cc",
                      *link], out["cxxnet"])
    return out


def embed_env(env: Dict[str, str] = None) -> Dict[str, str]:
    """An environment for a binary that embeds a fresh interpreter: the
    running interpreter's ``sys.path`` (the repo, its site-packages and
    a virtual environment's) as ``PYTHONPATH``."""
    env = dict(os.environ if env is None else env)
    paths = [str(REPO)] + [p for p in sys.path if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


if __name__ == "__main__":
    for key, path in build().items():
        print(f"{key}: {path}")  # disclint: ok(print) — the CLI's output

#!/usr/bin/env python3
"""A/B timing of one of the port's kernels across source trees, on one
CUDA card.

    python3 tools/kernel_ab.py --kernel KERNEL ROOT_A ROOT_B [...]
    python3 tools/kernel_ab.py --kernel KERNEL ROOT ROOT@NAME=VALUE[@...]

KERNEL is one of flash, wgrad, layernorm_bwd, max_pool_bwd, lrn_bwd,
max_pool_fwd, lrn_fwd.

Each ROOT holds a ``cxxnet_tpu_torch/`` package (a checkout, or a copy
with edited kernels under a git-ignored directory).  ``@NAME=VALUE``
after a root sets the kernel's ops module's attribute NAME to the Python
literal VALUE in that run (a plan constant: ``lrn_bwd``, ``lrn_fwd`` and
``max_pool_fwd`` take ``_PIECE``, ``_RESIDENT``, ``_FWD_RESIDENT``,
``FWD_SMEM``), so one
tree's plan variants need no second build.  The trees' kernels are
built first, all builds started together; then each run goes in a
process of its own, in the order A B .. B A, so drift of the card shows
as a difference between a run's two turns.  Each run prints one JSON
line:

- ``flash``: the flash rows of PERF.md's kernel table at chip_smoke.py's
  shapes, bf16: the forward at the served (16, 4096, 128) and the
  training (64, 4096, 128) causal shapes, the backward at the training
  shape, and the segmented forward and backward on chip_smoke.py's
  seeded documents; then the same at head width 256: dense causal at
  (16, 4096, 256) and segmented at the train_hd256 path's (32, 4096,
  256) (``hd256_``), and at head width 192 on the same shapes
  (``hd192_``); median milliseconds (CUDA events), the forwards' device
  ms too (``*fwd_dev_ms``, chip_smoke.device_ms), with the largest
  per-row error against the plain versions.
- ``wgrad``: rows 5 and 6 at AlexNet's conv1 (x (256, 3, 227, 227) to dy
  (256, 96, 55, 55), 11x11 stride 4, bf16): ``conv_wgrad_hwcn_pallas``'s
  device ms (chip_smoke.device_ms) and the largest error of dW / db
  against the plain version (max |diff| / max |ref|).  A tree whose
  kernel is edited to skip work times what is left and reports the
  error that follows.
- ``layernorm_bwd``: row 12 at the LM's training shape (16384, 2048)
  bf16, both residual contracts (one gamma column exactly 0): device ms
  and the largest error against the plain version (dx per row, dgamma /
  dbeta as max |diff| / max |ref|).
- ``max_pool_bwd``: row 4 at AlexNet's pool1 (256, 96, 55, 55), pool2
  (256, 256, 27, 27) and pool3 (256, 256, 13, 13), k3 s2 bf16, plain
  and relu-masked, on inputs with many tied maxima: device ms, and
  whether every dx is bitwise equal to the plain version's.
- ``lrn_bwd``: rows 1 and 2's backward at AlexNet's lrn1 (256, 96, 27,
  27) and lrn2 (256, 256, 13, 13), window 5, bf16, in both views (NCHW
  through ``lrn_bwd``, its (H, W, C, N) transpose through
  ``lrn_hwcn_bwd``): device ms and call ms (CUDA events around one
  call), and the largest per-row error against the plain versions.
- ``max_pool_fwd``: row 3 at AlexNet's pool1, pool2 and pool3 and
  MNIST_CONV's (100, 32, 14, 14), k3 s2 bf16, on inputs with many tied
  maxima: device ms and call ms, and whether every y is bitwise equal
  to the plain version's.
- ``lrn_fwd``: rows 1 and 2's forward as ``lrn_bwd`` times the
  backward: lrn1 and lrn2, window 5, bf16, both views, device ms and
  call ms, and the largest per-row error against the plain versions.

Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the ops module each kernel's timing imports from a tree
MODULES = {"flash": "flash_attention", "wgrad": "conv_wgrad",
           "layernorm_bwd": "layernorm", "max_pool_bwd": "pool",
           "lrn_bwd": "lrn", "max_pool_fwd": "pool", "lrn_fwd": "lrn"}


def _load(spec: str, kernel: str):
    """chip_smoke (from this checkout) and the module of ``kernel`` from
    the root of ``spec`` (``ROOT[@NAME=VALUE...]``), its settings
    applied."""
    import ast
    import importlib
    root, *settings = spec.split("@")
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(root))
    mod = importlib.import_module(f"cxxnet_tpu_torch.ops.{MODULES[kernel]}")
    if not mod.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"{root}: imported {mod.__file__}")
    for setting in settings:
        name, value = setting.split("=", 1)
        if not hasattr(mod, name):
            raise SystemExit(f"{mod.__name__} has no {name}")
        setattr(mod, name, ast.literal_eval(value))
    return chip_smoke, mod


def kernel_split(fn, reps: int = 20) -> dict:
    """Device ms a call of ``fn`` spends in each kernel (torch.profiler,
    ``reps`` back-to-back calls), by the kernel's function name."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: round(v / reps / 1e3, 5) for k, v in out.items()}


def build_tree(root: str, kernel: str) -> None:
    """Build the tree's kernels; print ptxas's warnings and the wgmma
    kernels' registers and spills (to stderr, prefixed by the root)."""
    cs, _ = _load(root, kernel)
    from cxxnet_tpu_torch.ops import build
    build.LIBRARY.get()
    log = build.LIBRARY.build_log
    for line in log.splitlines():
        if "arning" in line or "Performance Loss" in line:
            sys.stderr.write(f"{root}: {line.strip()}\n")
    for name, props in cs.wgmma_ptxas(log):
        sys.stderr.write(f"{root}: ptxas {name}: {props}\n")


def time_flash(cs, fa) -> dict:
    import numpy as np
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    out = {}
    q, k, v = (randn(cs.NHEAD, cs.SEQ, cs.DIM // cs.NHEAD) for _ in range(3))
    out["fwd_served_ms"] = cs.time_ms(
        lambda: fa.flash_attention_fwd(q, k, v, True), reps=20)
    errs = []
    for prefix, dense_bh, b, h, d in (
            ("", cs.TRAIN_BATCH * cs.NHEAD, cs.TRAIN_BATCH, cs.NHEAD,
             cs.DIM // cs.NHEAD),
            ("hd256_", 16, cs.TRAIN_BATCH, cs.WIDE_NHEAD, 256),
            ("hd192_", 16, cs.TRAIN_BATCH, cs.WIDE_NHEAD, 192)):
        s = cs.SEQ
        q, k, v, do = (randn(b * h, s, d) for _ in range(4))
        seg = torch.from_numpy(cs.seeded_segments(
            np.random.RandomState(3), b, s, 512)).to(dev)
        # dense causal on the first dense_bh slices, segmented on all
        qd, kd, vd, dod = (t[:dense_bh] for t in (q, k, v, do))
        for tag, fwd, bwd, fwd_plain, bwd_plain in (
                ("", lambda: fa.flash_attention_fwd(qd, kd, vd, True),
                 lambda o, l: fa.flash_attention_bwd(qd, kd, vd, o, l, dod,
                                                     True),
                 lambda: fa.flash_attention_fwd_plain(qd, kd, vd, True),
                 lambda o, l: fa.flash_attention_bwd_plain(
                     qd, kd, vd, o, l, dod, True)),
                ("seg_", lambda: fa.flash_attention_seg_fwd(q, k, v, seg),
                 lambda o, l: fa.flash_attention_seg_bwd(q, k, v, seg, o, l,
                                                         do),
                 lambda: fa.flash_attention_seg_fwd_plain(q, k, v, seg),
                 lambda o, l: fa.flash_attention_seg_bwd_plain(
                     q, k, v, seg, o, l, do))):
            out[f"{prefix}{tag}fwd_ms"] = cs.time_ms(fwd, reps=20)
            out[f"{prefix}{tag}fwd_dev_ms"] = cs.device_ms(fwd)
            o, lse = fwd()
            errs.append(cs.row_rel_err(o, fwd_plain()[0]))
            out[f"{prefix}{tag}bwd_ms"] = cs.time_ms(lambda: bwd(o, lse),
                                                     reps=20)
            errs += [cs.row_rel_err(g, r, cs.GRAD_ROW_FLOOR)
                     for g, r in zip(bwd(o, lse), bwd_plain(o, lse))]
    out["max_row_err"] = max(errs)
    return out


def time_wgrad(cs, cw) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    x = torch.rand((256, 3, 227, 227), generator=gen, device=dev).to(
        torch.bfloat16)
    dy = torch.randn((256, 96, 55, 55), generator=gen, device=dev).to(
        torch.bfloat16)
    run = lambda: cw.conv_wgrad_hwcn_pallas(x, dy, 11, 11, 4, 0, 0)
    got, ref = run(), cw.conv_wgrad_plain(x, dy, 11, 11, 4, 0, 0)
    return {"ms": cs.device_ms(run),
            "err": max(cs.rel_err(a, b) for a, b in zip(got, ref))}


def time_layernorm_bwd(cs, ln) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows, d = cs.TRAIN_BATCH * cs.SEQ, cs.DIM
    x = (torch.randn((rows, d), generator=gen, device=dev) * 2 + 3).to(
        torch.bfloat16)
    g = (torch.rand((d,), generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    g[5] = 0.0
    b = (torch.randn((d,), generator=gen, device=dev) * .5).to(
        torch.bfloat16)
    dy = torch.randn((rows, d), generator=gen, device=dev).to(
        torch.bfloat16)
    y, mean, rstd = ln.layernorm_fwd(x, g, b, cs.LN_EPS)
    out, errs = {}, []
    for save_x in (False, True):
        a = x if save_x else y
        run = lambda: ln.layernorm_bwd(dy, a, g, b, mean, rstd, save_x)
        got = run()
        ref = ln.layernorm_bwd_plain(dy, a, g, b, mean, rstd, save_x)
        errs += [cs.row_rel_err(got[0], ref[0]), cs.rel_err(got[1], ref[1]),
                 cs.rel_err(got[2], ref[2])]
        out["save_x_ms" if save_x else "ms"] = cs.device_ms(run)
        out["save_x_split" if save_x else "split"] = kernel_split(run)
    out["max_err"] = max(errs)
    return out


def time_max_pool_bwd(cs, pool) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    geom, out, bitwise = (3, 3, 2, 0, 0), {}, True
    for tag, shape in (("pool1", (256, 96, 55, 55)),
                       ("pool2", (256, 256, 27, 27)),
                       ("pool3", (256, 256, 13, 13))):
        x = (torch.round(torch.randn(shape, generator=gen, device=dev) * 6)
             / 4 - 0.5).to(torch.bfloat16)
        y = pool.max_pool_fwd(x, geom)
        dy = (torch.round(torch.randn(y.shape, generator=gen, device=dev)
                          * 8) / 8).to(torch.bfloat16)
        for relu in (False, True):
            run = lambda: pool.max_pool_bwd(x, y, dy, geom, relu)
            bitwise &= torch.equal(run(), pool.max_pool_bwd_plain(
                x, y, dy, geom, relu))
            out[f"{tag}{'_relu' if relu else ''}_ms"] = cs.device_ms(run)
    out["bitwise"] = bool(bitwise)
    return out


def _time_lrn(cs, lrn, backward: bool) -> dict:
    """Rows 1 and 2's forward or backward at lrn1 and lrn2, both views."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    args, out, errs = (5, 0.001, 0.75, 1.0), {}, []
    for tag, shape in (("lrn1", (256, 96, 27, 27)),
                       ("lrn2", (256, 256, 13, 13))):
        x = (torch.randn(shape, generator=gen, device=dev) * 8).to(
            torch.bfloat16)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        xt = x.permute(lrn.TO_HWCN).contiguous()
        gt = g.permute(lrn.TO_HWCN).contiguous()
        if backward:
            views = (("nchw", lambda: lrn.lrn_bwd(x, g, *args),
                      lambda: lrn.lrn_bwd_plain(x, g, *args)),
                     ("hwcn", lambda: lrn.lrn_hwcn_bwd(xt, gt, *args),
                      lambda: lrn.lrn_hwcn_bwd_plain(xt, gt, *args)))
        else:
            views = (("nchw", lambda: lrn.lrn_fwd(x, *args),
                      lambda: lrn.lrn_fwd_plain(x, *args)),
                     ("hwcn", lambda: lrn.lrn_hwcn_fwd(xt, *args),
                      lambda: lrn.lrn_hwcn_fwd_plain(xt, *args)))
        for view, run, plain in views:
            errs.append(cs.row_rel_err(run(), plain()))
            out[f"{tag}_{view}_ms"] = cs.device_ms(run)
            out[f"{tag}_{view}_call_ms"] = cs.time_ms(run, 20)
    out["max_row_err"] = max(errs)
    return out


def time_lrn_bwd(cs, lrn) -> dict:
    return _time_lrn(cs, lrn, True)


def time_lrn_fwd(cs, lrn) -> dict:
    return _time_lrn(cs, lrn, False)


def time_max_pool_fwd(cs, pool) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    geom, out, bitwise = (3, 3, 2, 0, 0), {}, True
    for tag, shape in (("pool1", (256, 96, 55, 55)),
                       ("pool2", (256, 256, 27, 27)),
                       ("pool3", (256, 256, 13, 13)),
                       ("mnist", (100, 32, 14, 14))):
        x = (torch.round(torch.randn(shape, generator=gen, device=dev) * 6)
             / 4 - 0.5).to(torch.bfloat16)
        run = lambda: pool.max_pool_fwd(x, geom)
        bitwise &= torch.equal(run(), pool.max_pool_fwd_plain(x, geom))
        out[f"{tag}_ms"] = cs.device_ms(run)
        out[f"{tag}_call_ms"] = cs.time_ms(run, 20)
    out["bitwise"] = bool(bitwise)
    return out


TIMERS = {"flash": time_flash, "wgrad": time_wgrad,
          "layernorm_bwd": time_layernorm_bwd,
          "max_pool_bwd": time_max_pool_bwd, "lrn_bwd": time_lrn_bwd,
          "max_pool_fwd": time_max_pool_fwd, "lrn_fwd": time_lrn_fwd}


def time_tree(root: str, kernel: str) -> dict:
    cs, mod = _load(root, kernel)
    return {"root": root, **TIMERS[kernel](cs, mod), "card": cs.card_line()}


def main() -> int:
    args = sys.argv[1:]
    if len(args) < 3 or args[0] != "--kernel" or args[1] not in TIMERS:
        raise SystemExit(__doc__)
    kernel, rest = args[1], args[2:]
    if rest[0] in ("--build", "--time") and len(rest) == 2:
        if rest[0] == "--build":
            build_tree(rest[1], kernel)
        else:
            sys.stdout.write(json.dumps(time_tree(rest[1], kernel)) + "\n")
        return 0
    me = [sys.executable, os.path.abspath(__file__), "--kernel", kernel]
    roots = sorted({r.split("@")[0] for r in rest})
    builds = [subprocess.Popen(me + ["--build", r]) for r in roots]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a build failed")
    for r in rest + rest[::-1]:
        subprocess.run(me + ["--time", r], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

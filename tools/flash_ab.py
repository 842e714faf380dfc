#!/usr/bin/env python3
"""A/B timing of the port's flash-attention kernels across source trees,
on one CUDA card.

    python3 tools/flash_ab.py ROOT_A ROOT_B [...]

Each ROOT holds a ``cxxnet_tpu_torch/`` package (a checkout, or a copy
with edited kernels under a git-ignored directory).  The trees' kernels
are built first, all builds started together; then each tree runs in a
process of its own, in the order A B .. B A, so drift of the card shows
as a difference between a tree's two runs.  A run times the flash rows
of PERF.md's kernel table at chip_smoke.py's shapes, bf16: the forward
at the served (16, 4096, 128) and the training (64, 4096, 128) causal
shapes, the backward at the training shape, and the segmented forward
and backward on chip_smoke.py's seeded documents; it prints one JSON
line of median milliseconds (CUDA events), with the largest per-row
error against the plain versions.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root: str):
    """chip_smoke (from this checkout) and ``root``'s flash module."""
    sys.path.insert(0, REPO)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(root))
    from cxxnet_tpu_torch.ops import build, flash_attention
    if not flash_attention.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"{root}: imported {flash_attention.__file__}")
    return chip_smoke, build, flash_attention


def build_tree(root: str) -> None:
    _, build, _ = _load(root)
    build.LIBRARY.get()


def time_tree(root: str) -> dict:
    import numpy as np
    import torch
    cs, _, fa = _load(root)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    out = {"root": root}
    q, k, v = (randn(cs.NHEAD, cs.SEQ, cs.DIM // cs.NHEAD) for _ in range(3))
    out["fwd_served_ms"] = cs.time_ms(
        lambda: fa.flash_attention_fwd(q, k, v, True), reps=20)
    b, h, s, d = cs.TRAIN_BATCH, cs.NHEAD, cs.SEQ, cs.DIM // cs.NHEAD
    q, k, v, do = (randn(b * h, s, d) for _ in range(4))
    seg = torch.from_numpy(cs.seeded_segments(np.random.RandomState(3), b, s,
                                              512)).to(dev)
    errs = []
    for tag, fwd, bwd, fwd_plain, bwd_plain in (
            ("", lambda: fa.flash_attention_fwd(q, k, v, True),
             lambda o, l: fa.flash_attention_bwd(q, k, v, o, l, do, True),
             lambda: fa.flash_attention_fwd_plain(q, k, v, True),
             lambda o, l: fa.flash_attention_bwd_plain(q, k, v, o, l, do,
                                                       True)),
            ("seg_", lambda: fa.flash_attention_seg_fwd(q, k, v, seg),
             lambda o, l: fa.flash_attention_seg_bwd(q, k, v, seg, o, l, do),
             lambda: fa.flash_attention_seg_fwd_plain(q, k, v, seg),
             lambda o, l: fa.flash_attention_seg_bwd_plain(q, k, v, seg, o,
                                                           l, do))):
        out[f"{tag}fwd_ms"] = cs.time_ms(fwd, reps=20)
        o, lse = fwd()
        errs.append(cs.row_rel_err(o, fwd_plain()[0]))
        out[f"{tag}bwd_ms"] = cs.time_ms(lambda: bwd(o, lse), reps=20)
        errs += [cs.row_rel_err(g, r, cs.GRAD_ROW_FLOOR)
                 for g, r in zip(bwd(o, lse), bwd_plain(o, lse))]
    out["max_row_err"] = max(errs)
    out["card"] = cs.card_line()
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] in ("--build", "--time"):
        if sys.argv[1] == "--build":
            build_tree(sys.argv[2])
        else:
            sys.stdout.write(json.dumps(time_tree(sys.argv[2])) + "\n")
        return 0
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in roots]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a build failed")
    for r in roots + roots[::-1]:
        subprocess.run([sys.executable, me, "--time", r], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

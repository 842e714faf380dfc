"""The numbers that decide ``correct``, worked out from the program's
state and outputs on one side and the plain reference on the other.

Training (the first three steps of the timed path): each step's loss
and the first step's alone (its forward from the seeded weights, before
any update's rounding), the norm of each leaf's first gradient as the optimizer got it (from
its state after one step), and the norm of each leaf's change after the
three steps, both by the worst leaf: the gap between the two norms over
the larger of the reference's norm of that leaf and of the median leaf.
A leaf is a parameter as the reference counts them (a fused q, k, v
projection is three).  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left
out of both.

Rows (a prediction's answers): each row's normwise relative error
against the reference's row, the worst row.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out
NOUGHT = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def loss1_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The first step's loss gap."""
    return loss_gap(prog[:1], ref[:1]) if prog and ref else float("inf")


def moved_leaves(ref_grad: Dict[str, float]) -> list:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= NOUGHT * med]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys
             ) -> Tuple[float, Optional[str]]:
    """The worst leaf's gap between the program's norm and the
    reference's, and that leaf."""
    med = float(np.median([ref[k] for k in keys]))
    worst, at = 0.0, None
    for k in keys:
        if k not in prog:
            return float("inf"), k
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not np.isfinite(g):
            return float("inf"), k
        if g >= worst:
            worst, at = g, k
    return worst, at


def training_checks(run, prog: dict, ref: dict) -> None:
    """``run.check`` the training numbers of ``prog`` (the program's
    losses, first-gradient and change norms) against ``ref`` (the
    reference's) that the cell's limits name; the others are printed
    and not compared (a number that neither the control nor a fault
    separates from sound runs)."""
    keys = moved_leaves(ref["grad_norms"])
    left_out = sorted(set(ref["grad_norms"]) - set(keys))
    g, g_at = leaf_gap(prog["grad_norms"], ref["grad_norms"], keys)
    c, c_at = leaf_gap(prog["change"], ref["change"], keys)
    got = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "loss1_gap": loss1_gap(prog["losses"], ref["losses"]),
           "grad_gap": g, "change_gap": c}
    for name, value in got.items():
        if name in run.limits:
            run.check(name, value, run.limits[name])
    print(f"bench: losses program {prog['losses']} reference "
          f"{ref['losses']}; worst gradient leaf {g_at}, worst change leaf "
          f"{c_at}; left out {left_out}; not compared "
          f"{ {k: v for k, v in got.items() if k not in run.limits} }",
          file=sys.stderr)


def leaf_norms(trainer, tensors, part_norms, scale: float = 1.0
               ) -> Dict[str, float]:
    """``{"layer/tag[.part]": norm}`` of a per-leaf tensor of a program's
    trainer (``tensors(pkey, tag, param)`` gives it), each leaf cut into
    the parameters it holds by the reference's ``part_norms``."""
    out: Dict[str, float] = {}
    for pkey, group in trainer.params.items():
        for tag, p in group.items():
            name = f"{pkey.split('-', 1)[1]}/{tag}"
            out.update({k: v * scale for k, v in
                        part_norms(name, tensors(pkey, tag, p)).items()})
    return out


def master(trainer, pkey: str, tag: str, p):
    """A parameter's float32 value as its next update starts from: its
    master copy where it has one."""
    st = trainer.opt_state[pkey][tag]
    return st["w32"] if "w32" in st else p


def row_error(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's normwise relative error."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.maximum(np.linalg.norm(ref, axis=1), 1e-30)
    return np.linalg.norm(got - ref, axis=1) / den

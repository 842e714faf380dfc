"""SPMD deep lint: collective consistency, in-place state and dtype flow
(the JAX package's ``analysis/spmdlint.py``).

The third ``task = check`` pass, after the config lint and the graph
lint, over the same traced step (``graph_lint.trace_step``, traced once
a check): the bug classes that stay invisible until the cards are busy,
and that on several processes show up as a hang, not a stack trace.

* **collective consistency** — the port's collectives are calls into
  ``parallel/mesh.py``, not graph nodes (on the virtual mesh of ``task =
  check`` they return their input and leave no node), so the trace
  records them instead: while the step is traced, every collective and
  every pipeline stage handoff it issues appends ``(op, axes, dtype,
  numel)`` in call order (``mesh.recording``).  That record is the
  port's counterpart of the jaxpr walk (:func:`collective_walk`); the
  census per axis (``spmd_collectives``), the axis audit
  (``spmd_unknown_axis``, ``spmd_dead_axis``) and the bf16-wire contract
  (``spmd_f32_wire``) read it.  The mesh module never issues a
  collective over an axis of size 1 or one the mesh lacks (it returns
  its input), so on a traced port step the two axis rules stay quiet;
  they hold any record handed to them to the JAX package's rules.
* **divergent branches** (``spmd_divergent_cond``): the port has no
  such check.  A torch step traces no ``lax.cond``: every branch is
  resolved on the host before anything is issued, so the trace holds
  the one branch a rank took, and no traced program can carry two
  collective sequences to compare.  :func:`collective_walk` takes no
  branches and the key never fires.
* **in-place state** (``spmd_undonated``, ``spmd_donation``): torch has
  no XLA donation.  What donation buys there, one copy of each state
  leaf across the step, the port gets by updating the leaves in place;
  the audit checks that the traced step hands back every parameter and
  optimizer-state leaf as the very tensor it took in (an error for each
  tree with a leaf the step replaced by a new tensor: both copies are
  alive until the step returns).  Buffers (batch_norm's moving
  statistics) are new tensors a step by design, as the JAX package's
  buffers are new arrays, and are not audited.
* **dtype flow** — over the traced graph: a direct f32 -> bf16 -> f32
  cast pair (``aten._to_copy`` or ``prims.convert_element_type``;
  ``spmd_cast_roundtrip``), bf16 sums deeper than
  :data:`BF16_ACC_DEPTH` (``spmd_bf16_acc``: an error when the operand
  comes straight from an f32 downcast, else a warning) and bf16 matmul
  contractions deeper than :data:`BF16_DOT_DEPTH` (``spmd_bf16_dot``,
  advisory: the tensor cores accumulate in f32), with the JAX module's
  thresholds.
* ``spmd_dist_round_len`` — an iterator sharded ``dist_num_worker``
  ways feeding a step that issues collectives, as in the JAX package.

Finding keys and severities are the JAX package's (``FINDING_IDS``);
findings carry ``scope = "spmd"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .schema import Finding

#: a single bf16 sum over more than this many elements is flagged
#: (bf16 carries 8 mantissa bits: an N-deep naive sum's relative error
#: grows ~N * 2^-8)
BF16_ACC_DEPTH = 4096

#: bf16 matmul contraction depth that earns the info note (the tensor
#: cores accumulate in f32, so it is advisory only)
BF16_DOT_DEPTH = 16384

#: f32 reductions smaller than this are exempt from the bf16-wire rule
#: (the step's reduced scalar loss is f32 by design)
F32_WIRE_MIN_BYTES = 1 << 16

#: the recorded ops that sum over their axes
REDUCTIONS = ("all_reduce", "reduce_scatter")

#: finding id -> one-line meaning (the JAX package's catalogue)
FINDING_IDS = {
    "spmd_unknown_axis": "collective names a mesh axis the built mesh "
                         "does not carry",
    "spmd_dead_axis": "collective on a size-1 mesh axis",
    "spmd_divergent_cond": "branches carry different collective "
                           "sequences (no torch counterpart: the host "
                           "resolves every branch)",
    "spmd_undonated": "a parameter or optimizer-state leaf the step "
                      "replaces instead of updating in place (two copies "
                      "alive across the step)",
    "spmd_f32_wire": "f32 reduction on the data axis despite "
                     "dp_reduce_dtype = bf16",
    "spmd_bf16_acc": "bf16 reduction deeper than the accumulation-depth "
                     "threshold",
    "spmd_bf16_dot": "bf16 matmul contraction deeper than the advisory "
                     "threshold (the tensor cores accumulate in f32)",
    "spmd_cast_roundtrip": "direct f32->bf16->f32 cast round-trip",
    "spmd_collectives": "per-axis collective sequence summary",
    "spmd_donation": "in-place state audit summary",
    "spmd_dist_round_len": "dist_num_worker-sharded iterator feeds a "
                           "step whose per-round batch count derives "
                           "from LOCAL iterator length",
}

_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int8": 1, "uint8": 1, "bool": 1}


@dataclasses.dataclass
class CollectiveOp:
    """One recorded collective (or stage handoff), in call order."""

    prim: str
    axes: Tuple[str, ...]
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int

    def sig(self) -> Tuple:
        """Two ranks agreeing on this tuple issue compatible calls."""
        return (self.prim, self.axes, self.dtype, self.shape)


def collective_walk(record: Sequence[Tuple[str, Tuple[str, ...], str, int]],
                    ops: List[CollectiveOp],
                    findings: List[Finding]) -> None:
    """Append the collective sequence of a ``mesh.recording`` record to
    ``ops``.  ``findings`` would take the divergent-branch errors of the
    JAX walk; a torch trace has no branches to compare, so none come."""
    for op, axes, dtype, numel in record:
        ops.append(CollectiveOp(prim=op, axes=tuple(axes), dtype=dtype,
                                shape=(int(numel),),
                                nbytes=int(numel) * _ITEMSIZE.get(dtype, 4)))


def axis_findings(ops: Sequence[CollectiveOp],
                  axis_sizes: Dict[str, int]) -> List[Finding]:
    """Dead / unknown-axis findings (one per axis and op)."""
    out: List[Finding] = []
    seen = set()
    for op in ops:
        for ax in op.axes:
            key = (ax, op.prim)
            if key in seen:
                continue
            seen.add(key)
            if ax not in axis_sizes:
                from .schema import did_you_mean
                out.append(Finding(
                    "error", "spmd_unknown_axis",
                    f"{op.prim} over mesh axis {ax!r} which the built "
                    f"mesh does not carry (axes: "
                    f"{', '.join(axis_sizes) or 'none'}); a rank waiting "
                    "on an axis nobody else joins is a hang, not an "
                    "error", suggestion=did_you_mean(ax, list(axis_sizes)),
                    scope="spmd"))
            elif axis_sizes[ax] == 1:
                out.append(Finding(
                    "error", "spmd_dead_axis",
                    f"{op.prim} over mesh axis {ax!r} of size 1: the "
                    "collective moves nothing; widen the axis in mesh= "
                    "or drop the collective path", scope="spmd"))
    return out


def sequence_summary(ops: Sequence[CollectiveOp]) -> Finding:
    """One info finding: the collective census per axis."""
    if not ops:
        return Finding(
            "info", "spmd_collectives",
            "traced step issues no collectives (one device, or a mesh "
            "whose axes are all of size 1)", scope="spmd")
    per_axis: Dict[str, Dict[str, int]] = {}
    for op in ops:
        name = ",".join(op.axes)
        counts = per_axis.setdefault(name, {})
        counts[op.prim] = counts.get(op.prim, 0) + 1
    parts = [ax + ": " + ", ".join(f"{p} x{n}" for p, n in
                                   sorted(per_axis[ax].items()))
             for ax in sorted(per_axis)]
    return Finding(
        "info", "spmd_collectives",
        f"{len(ops)} collective(s) in the traced step — "
        + "; ".join(parts), scope="spmd")


# ------------------------------------------------------------ dtype flow
_SUMS = ("sum",)
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "matmul")


def _packet(node) -> str:
    pkt = getattr(node.target, "_overloadpacket", None)
    return getattr(pkt, "__name__", None) or getattr(
        node.target, "__name__", str(node.target))


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _dt(node) -> Optional[torch.dtype]:
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _is_cast(node) -> bool:
    return node.op == "call_function" and _packet(node) in (
        "_to_copy", "convert_element_type", "to")


def _cast_pair(node) -> Optional[Tuple[torch.dtype, torch.dtype]]:
    """(source, destination) dtypes of a cast node."""
    if not _is_cast(node) or not node.args:
        return None
    src = node.args[0]
    if not hasattr(src, "meta"):
        return None
    s, d = _dt(src), _dt(node)
    return (s, d) if s is not None and d is not None and s != d else None


def dtype_flow_findings(gm: torch.fx.GraphModule,
                        acc_depth: int = BF16_ACC_DEPTH) -> List[Finding]:
    """Cast round-trips, deep bf16 sums and deep bf16 matmuls in a
    traced step's graph."""
    roundtrips = 0
    warn_reduces: List[Tuple[int, Tuple[int, ...]]] = []
    err_reduces: List[Tuple[int, Tuple[int, ...]]] = []
    deep_dots, max_dot_depth = 0, 0
    bf16, f32 = torch.bfloat16, torch.float32
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _packet(node)
        pair = _cast_pair(node)
        if pair == (bf16, f32):
            prev = _cast_pair(node.args[0])
            if prev == (f32, bf16):
                roundtrips += 1
        elif name in _SUMS and node.args and _dt(node.args[0]) == bf16:
            src = node.args[0]
            shape = tuple(int(d) for d in _val(src).shape)
            dims = node.args[1] if len(node.args) > 1 else None
            if dims is None:
                dims = list(range(len(shape)))
            elif isinstance(dims, int):
                dims = [dims]
            depth = 1
            for a in dims:
                depth *= shape[a]
            if depth > acc_depth:
                downcast = _cast_pair(src) == (f32, bf16)
                (err_reduces if downcast else warn_reduces).append(
                    (depth, shape))
        elif name in _DOTS and _dt(node) == bf16:
            lhs = node.args[1] if name in ("addmm", "baddbmm") \
                else node.args[0]
            v = _val(lhs)
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                depth = int(v.shape[-1])
                if depth > BF16_DOT_DEPTH:
                    deep_dots += 1
                    max_dot_depth = max(max_dot_depth, depth)
    out: List[Finding] = []
    if err_reduces:
        depth, shape = max(err_reduces)
        out.append(Finding(
            "error", "spmd_bf16_acc",
            f"{len(err_reduces)} reduction(s) sum f32 values through a "
            f"deliberate bf16 downcast, up to {depth} elements deep "
            f"(operand {shape}): an N-deep bf16 sum loses ~N*2^-8 "
            "relative precision — accumulate in f32 and cast the "
            f"result, or keep the chain under {acc_depth}", scope="spmd"))
    if warn_reduces:
        depth, shape = max(warn_reduces)
        out.append(Finding(
            "warn", "spmd_bf16_acc",
            f"{len(warn_reduces)} bf16 reduction(s) deeper than "
            f"{acc_depth} (max {depth}, operand {shape}): bf16 carries "
            "8 mantissa bits, so thousands-deep sums (bias grads, "
            "pooled statistics) shed trailing bits; consider an f32 "
            "accumulation dtype on those chains", scope="spmd"))
    if deep_dots:
        out.append(Finding(
            "info", "spmd_bf16_dot",
            f"{deep_dots} bf16 matmul contraction(s) deeper than "
            f"{BF16_DOT_DEPTH} (max {max_dot_depth}); the tensor cores "
            "accumulate matmuls in f32, so this is advisory", scope="spmd"))
    if roundtrips:
        out.append(Finding(
            "warn", "spmd_cast_roundtrip",
            f"{roundtrips} direct f32->bf16->f32 cast round-trip(s) in "
            "the traced step: the value loses 16 mantissa bits and gains "
            "nothing (no collective between the casts) — outside the "
            "dp_reduce_dtype wire this is a precision bug, not a "
            "bandwidth saving", scope="spmd"))
    return out


def wire_findings(ops: Sequence[CollectiveOp], wire_bf16: bool
                  ) -> List[Finding]:
    """f32 reductions on the data axis when the config declared a bf16
    wire (``dp_reduce_dtype = bf16``)."""
    if not wire_bf16:
        return []
    bad = [op for op in ops if op.prim in REDUCTIONS and "data" in op.axes
           and op.dtype == "float32" and op.nbytes >= F32_WIRE_MIN_BYTES]
    if not bad:
        return []
    total_mb = sum(op.nbytes for op in bad) / 2 ** 20
    worst = max(bad, key=lambda op: op.nbytes)
    return [Finding(
        "error", "spmd_f32_wire",
        f"dp_reduce_dtype = bf16 declares a bf16 wire, but {len(bad)} "
        f"data-axis reduction(s) move f32 ({total_mb:.1f} MiB per step, "
        f"largest {worst.shape} {worst.prim}): the declared saving never "
        "happens — cast to bf16 before the reduction or drop the "
        "dp_reduce_dtype claim", scope="spmd")]


# ------------------------------------------------------ in-place audit
def donation_findings(report: Optional[Dict[str, Any]]) -> List[Finding]:
    """Audit a traced step's state leaves: ``report`` is
    ``graph_lint.trace_step``'s ``audit["donation"]``, the JAX
    package's report shape (``source``, ``leaves``: rows of ``tree``,
    ``path``, ``bytes`` and ``donated``, here whether the step handed the
    leaf back as the very tensor it took in, updated in place, and
    ``alias_bytes``, their bytes).  One ``spmd_undonated`` error a tree
    (params, opt_state) with a replaced leaf, then the ``spmd_donation``
    summary; None (no report) is the skip notice."""
    if report is None:
        return [Finding(
            "info", "spmd_donation",
            "in-place audit skipped: the traced step left no state "
            "report", scope="spmd")]
    out: List[Finding] = []
    rows = report["leaves"]
    for tree in ("params", "opt_state"):
        missing = [r for r in rows if r["tree"] == tree
                   and not r["donated"]]
        if not missing:
            continue
        total_mb = sum(r["bytes"] for r in missing) / 2 ** 20
        names = ", ".join(r["path"] for r in missing[:3])
        if len(missing) > 3:
            names += f", ... ({len(missing) - 3} more)"
        out.append(Finding(
            "error", "spmd_undonated",
            f"{len(missing)} {tree} leaf/leaves replaced by a new tensor "
            f"instead of updated in place ({total_mb:.1f} MiB held twice "
            f"across the step: {names}); update the leaf in place (the "
            "updaters' own rule) so one copy lives", scope="spmd"))
    donated = [r for r in rows if r["donated"]]
    out.append(Finding(
        "info", "spmd_donation",
        f"in-place audit: {len(donated)}/{len(rows)} state leaves "
        f"updated in place ({report['alias_bytes'] / 2 ** 20:.1f} MiB, "
        f"source={report['source']})", scope="spmd"))
    return out


# --------------------------------------------------------------- driver
def dist_round_findings(cfg, ops: Sequence[CollectiveOp]) -> List[Finding]:
    """An iterator sharded ``dist_num_worker`` ways ends a rank's round
    when its LOCAL shard runs dry, so ranks with unequal shards issue
    different numbers of collectives and the longer ones hang (the JAX
    package's rule)."""
    try:
        nworker = int(dict(cfg).get("dist_num_worker", "1"))
    except (TypeError, ValueError):
        return []
    if nworker <= 1 or not ops:
        return []
    return [Finding(
        "warn", "spmd_dist_round_len",
        f"iterator is sharded dist_num_worker = {nworker} ways but each "
        "training round ends when the LOCAL iterator is exhausted, so "
        f"the number of collectives a rank issues per round ({len(ops)} "
        "per step x local step count) derives from its own shard "
        "length; ranks with unequal shard sizes issue divergent "
        "collective counts and the longer ranks hang in the next "
        "collective",
        suggestion="keep per-rank shard counts equal (shard count a "
                   "multiple of dist_num_worker, equal-length shards); "
                   "the iterator init asserts only the zero-shard case "
                   "('a rank with zero data would dispatch no steps and "
                   "hang the other replicas' collectives'), not unequal "
                   "nonzero ones",
        scope="spmd")]


def lint_trainer(trainer, traced: Tuple, audit: Dict, cfg) -> List[Finding]:
    """The SPMD analyses over a meta-built trainer's traced step
    (``graph_lint.trace_step``'s result and its ``audit``)."""
    gm = traced[0]
    findings: List[Finding] = []
    ops: List[CollectiveOp] = []
    collective_walk(audit.get("collectives", ()), ops, findings)
    mesh = trainer.mesh
    sizes = dict(mesh.axes) if mesh is not None else {}
    findings.extend(axis_findings(ops, sizes))
    findings.append(sequence_summary(ops))
    findings.extend(dtype_flow_findings(gm))
    findings.extend(wire_findings(
        ops, wire_bf16=trainer.opts.dp_reduce_dtype == "bf16"))
    findings.extend(donation_findings(audit.get("donation")))
    findings.extend(dist_round_findings(cfg, ops))
    return findings

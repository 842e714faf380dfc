"""Analytic per-layer memory model and the OOM pre-flight (the JAX
package's ``analysis/memmodel.py`` over the port's trainer).

The byte-side twin of :mod:`.costmodel`: per-layer parameter, gradient,
optimizer-state and activation bytes over a BUILT
:class:`~..nnet.trainer.NetTrainer`, keyed by the ``conn_scope_name``
strings the observatory joins on.  Two consumers:

* the ``mem_profile`` record (``monitor/memory.py``) carries each row's
  ``model_bytes`` / ``model_x``: the distance between the allocator's
  measurement and the model, per layer;
* ``task = check`` runs :func:`preflight` against the target card's
  memory (``costmodel.HBM_BYTES``) and errors when the estimated peak
  exceeds it (warns inside ``mem_margin_pct``), with remediations in the
  finding's text.

Bytes are counted from tensors (``numel() * element_size()``), which
works on the ``meta`` tensors of the device-free build ``task = check``
makes.  Accounting is per rank: a trainer on a mesh holds its shards
(a ZeRO slice of the optimizer state, a model shard of a fullc weight),
so its tensors count what the rank holds, and activations divide the
global batch by the mesh's data axis.  The model is coarse on the cost
model's terms: a ranking aid and a conservative pre-flight ceiling, not
a calibrated simulator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import costmodel
from .schema import Finding

#: unmodelled-temporary slack the pre-flight adds on top of the analytic
#: sum (library workspaces, allocator fragmentation)
WORKSPACE_FRAC = 0.10


def leaf_device_bytes(leaf: torch.Tensor) -> int:
    """Bytes of one tensor (its shape and dtype: a ``meta`` tensor
    counts as the tensor it stands for)."""
    return int(leaf.numel()) * leaf.element_size()


def tree_device_bytes(tree) -> int:
    """Bytes of a (possibly nested) dict of tensors."""
    total = 0
    for v in tree.values():
        total += tree_device_bytes(v) if isinstance(v, dict) \
            else leaf_device_bytes(v)
    return total


def _opt_tree(trainer, pkey: str):
    """The optimizer state of parameter group ``pkey``: the trainer's
    when it holds one (it makes it at the first update), else the state
    the updater would make, built on ``meta`` tensors (the f32 masters
    of reduced-precision parameters included)."""
    if trainer.opt_state is not None:
        return trainer.opt_state[pkey]
    return {tag: trainer.updater.make_state(
                trainer._opt_view(pkey, tag, p).to("meta"))
            for tag, p in trainer.params[pkey].items()}


def param_rows(trainer) -> Dict[str, Dict[str, int]]:
    """scope -> ``{param_bytes, opt_bytes}`` from the trainer's tensors.
    Shared connections contribute nothing: their parameters alias the
    primary's."""
    from ..layers.base import conn_scope_name
    out: Dict[str, Dict[str, int]] = {}
    for i, conn in enumerate(trainer.net.connections):
        if not conn.owns_params or conn.param_key not in trainer.params:
            continue
        out[conn_scope_name(i, conn)] = {
            "param_bytes": tree_device_bytes(
                trainer.params[conn.param_key]),
            "opt_bytes": tree_device_bytes(
                _opt_tree(trainer, conn.param_key)),
        }
    return out


def layer_mem(trainer) -> Dict[str, Dict[str, int]]:
    """scope -> ``{param_bytes, grad_bytes, opt_bytes, act_bytes}`` for
    EVERY connection (shared ones carry activations but no params).
    ``act_bytes`` is the connection's output activation in the net's
    dtype: what it costs while live between forward and backward; the
    remat / batch_split residency corrections are made in
    :func:`totals`, where they are properties of the schedule."""
    from ..layers.base import conn_scope_name
    from ..parallel.data import data_size
    itemsize = torch.empty((), dtype=trainer.dtype).element_size()
    ndata = data_size(trainer.mesh)
    prows = param_rows(trainer)
    out: Dict[str, Dict[str, int]] = {}
    for i, conn in enumerate(trainer.net.connections):
        scope = conn_scope_name(i, conn)
        act = 0
        for nid in conn.nindex_out:
            n = 1
            for d in trainer.net.node_shapes[nid]:
                n *= int(d)
            act += (n // ndata) * itemsize
        pr = prows.get(scope, {})
        pbytes = int(pr.get("param_bytes", 0))
        out[scope] = {
            "param_bytes": pbytes,
            # gradients materialise in the parameter dtype during the
            # backward: transient, but live together near the update
            "grad_bytes": pbytes,
            "opt_bytes": int(pr.get("opt_bytes", 0)),
            "act_bytes": act,
        }
    return out


def totals(trainer, per_layer: Optional[Dict[str, Dict[str, int]]] = None
           ) -> Dict[str, int]:
    """Byte totals and the estimated peak the pre-flight checks, with
    the schedule's corrections:

    * ``remat = K``: only segment-boundary activations persist across
      the backward, and one segment's recompute is live at a time —
      held = each segment's LAST activation, live = the largest
      segment's sum;
    * ``batch_split = K``: activations divide by K (one sub-batch chain
      live at a time);
    * ``update_period > 1``: the gradient accumulator persists between
      micro-steps (parameter-shaped; halved under ``dp_reduce_dtype =
      bf16``).
    """
    per_layer = per_layer or layer_mem(trainer)
    acts = [v["act_bytes"] for v in per_layer.values()]
    param = sum(v["param_bytes"] for v in per_layer.values())
    grad = sum(v["grad_bytes"] for v in per_layer.values())
    opt = sum(v["opt_bytes"] for v in per_layer.values())
    act = sum(acts)
    remat = int(trainer.remat or 0)
    if remat > 1 and len(acts) >= remat:
        chunk = max(len(acts) // remat, 1)
        segs = [acts[j: j + chunk] for j in range(0, len(acts), chunk)]
        held = sum(s[-1] for s in segs if s)
        live = max(sum(s) for s in segs)
        # capped: on shallow nets boundary + window can exceed the plain
        # sum; remat never costs more than keeping everything here
        act = min(held + live, act)
    if trainer.batch_split > 1:
        act = act // trainer.batch_split
    acc = 0
    if trainer.update_period > 1:
        acc = param
        if trainer.opts.dp_reduce_dtype == "bf16":
            acc = acc // 2
    buffers = tree_device_bytes(trainer.buffers or {})
    est = param + grad + opt + acc + act + buffers
    est += int(est * WORKSPACE_FRAC)
    return {"param_bytes": param, "grad_bytes": grad,
            "opt_bytes": opt, "acc_bytes": acc, "act_bytes": act,
            "buffer_bytes": buffers, "est_peak_bytes": est}


def _fmt_gb(b: float) -> str:
    return f"{b / 1e9:.2f} GB"


def _remediations(trainer, tot: Dict[str, int]) -> List[str]:
    """Knob suggestions, the largest modelled saving first."""
    from ..parallel.data import data_size
    out: List[Tuple[int, str]] = []
    act, opt, acc = tot["act_bytes"], tot["opt_bytes"], tot["acc_bytes"]
    if int(trainer.remat or 0) <= 1 and act:
        out.append((act // 2, "remat = 2..4 (checkpoint activations; "
                    f"~{_fmt_gb(act / 2)} off)"))
    if trainer.batch_split <= 1 and act:
        out.append((act // 2, "batch_split = 2 (halve live "
                    f"activations; ~{_fmt_gb(act / 2)} off)"))
    nd = data_size(trainer.mesh)
    if not trainer.shard_opt_state and nd > 1 and opt:
        save = opt - opt // nd
        out.append((save, "shard_opt_state = 1 (ZeRO over the data "
                    f"axis; ~{_fmt_gb(save)} off)"))
    if acc and trainer.opts.dp_reduce_dtype != "bf16":
        out.append((acc // 2, "dp_reduce_dtype = bf16 (halve the "
                    f"grad accumulator; ~{_fmt_gb(acc / 2)} off)"))
    out.sort(key=lambda kv: -kv[0])
    return [s for _, s in out]


def preflight(trainer, cfg_pairs) -> List[Finding]:
    """The OOM pre-flight behind ``task = check`` (``mem_check = 1``):
    the analytic model against the target card's memory, reported
    before a build-and-train cycle is spent.

    The card is ``mem_chip`` (``h100`` or a full device name), else the
    config's ``dev`` when it names one.  An unresolvable card returns no
    findings here: the lint rule (``conflint._mem_rules``) already warns
    about it on every check.  An estimated peak over capacity is an
    ERROR; within ``mem_margin_pct`` (default 10) of capacity a WARNING;
    otherwise one info finding records the headroom.  Remediation knobs
    ride in the finding's text, the largest modelled saving first."""
    last = dict(cfg_pairs)
    if last.get("mem_check", "0") != "1":
        return []
    sel = last.get("mem_chip", "") or last.get("dev", "")
    chip = costmodel.resolve_chip(sel)
    if chip is None:
        return []
    cap = costmodel.HBM_BYTES[chip]
    try:
        margin = float(last.get("mem_margin_pct", "10"))
    except ValueError:
        margin = 10.0
    tot = totals(trainer)
    est = tot["est_peak_bytes"]
    parts = (f"params {_fmt_gb(tot['param_bytes'])} + grads "
             f"{_fmt_gb(tot['grad_bytes'])} + opt "
             f"{_fmt_gb(tot['opt_bytes'])} + acts "
             f"{_fmt_gb(tot['act_bytes'])}"
             + (f" + acc {_fmt_gb(tot['acc_bytes'])}"
                if tot["acc_bytes"] else "")
             + f" + {int(WORKSPACE_FRAC * 100)}% workspace")
    findings: List[Finding] = []
    if est > cap:
        fix = _remediations(trainer, tot)
        msg = (f"estimated peak HBM {_fmt_gb(est)} exceeds {chip} "
               f"capacity {_fmt_gb(cap)} per device ({parts})")
        if fix:
            msg += "; did you mean: " + "; ".join(fix)
        findings.append(Finding("error", "mem_check", msg, scope="mem"))
    elif est > cap * (1.0 - margin / 100.0):
        fix = _remediations(trainer, tot)
        findings.append(Finding(
            "warn", "mem_check",
            f"estimated peak HBM {_fmt_gb(est)} is within "
            f"{margin:g}% of {chip} capacity {_fmt_gb(cap)} "
            f"({parts}); consider: " + "; ".join(fix[:2]), scope="mem"))
    else:
        findings.append(Finding(
            "info", "mem_check",
            f"estimated peak HBM {_fmt_gb(est)} of {chip} "
            f"{_fmt_gb(cap)} ({est / cap:.0%} full; {parts})",
            scope="mem"))
    return findings

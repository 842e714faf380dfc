"""Traced-graph lint: trace the train step to one graph, walk its nodes.

The counterpart of the JAX package's ``analysis/jaxpr_lint.py``.  The
config lint catches what a key *says*; this pass catches what the
traced program *does*:

* **large baked-in constants** — a tensor the step closes over instead
  of taking it through params / buffers / inputs (in the graph, a
  ``get_attr`` of a lifted tensor constant) is captured into every
  traced program and pins device memory.  Flagged above 1 MiB, an
  error.
* **silent f32 -> f64 promotions** — float64 values produced by an op
  (a stray numpy float64 or ``torch.float64`` factory) double memory
  and leave the tensor cores; flagged per op, a warning.
* **state leaves that change type** — torch has no weak types, so the
  JAX package's weak-typed-leaf rule becomes its hazard's other half: a
  parameter, optimizer-state or buffer leaf that the traced step hands
  back in another dtype than it took in.  The next step then runs
  another program on it (the retrace the JAX rule predicts), and a
  snapshot records the wrong type.  A warning.
* **gradient leaves escaping the dp reduction** — under ``dp_overlap =
  1`` every parameter group must sit in a bucket of the plan, the
  pipelined 1F1B step's per-stage plan on a pipe mesh
  (:func:`dp_findings`); an inactive plan (a fallback gate) is an info
  line.

Tracing: :func:`trace_step` runs ``torch.fx.experimental.proxy_tensor.
make_fx`` over the step the trainer runs — forward, loss, backward
(``torch.autograd.grad``, recorded at the aten level below autograd)
and the in-place update — with the meta-built trainer of ``task =
check`` (``analysis/__init__.py``): every tensor is a shape without
storage, the kernel wrappers take their plain versions on ``meta``
(``ops/build.PLAIN_DEVICES``), and factory calls that name a device
(the layers' random masks) are made on ``meta``, their generator
dropped.  No device is touched and nothing launches.  Findings
carry ``scope = "jaxpr"`` and the JAX package's severities and words, so
records and ``tools/obsv.py`` read them unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..nnet.net import _OnMeta
from .schema import Finding

#: closure-captured constants larger than this are findings
CONST_BYTES_LIMIT = 1 << 20


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _nbytes(t) -> int:
    try:
        return int(t.numel()) * int(t.element_size())
    except (AttributeError, RuntimeError, TypeError):
        return 0


def _op_name(target) -> str:
    pkt = getattr(target, "_overloadpacket", None)
    return getattr(pkt, "__name__", None) or getattr(
        target, "__name__", str(target))


def graph_findings(gm: torch.fx.GraphModule,
                   const_bytes_limit: int = CONST_BYTES_LIMIT
                   ) -> List[Finding]:
    """Lint one traced graph: large closure constants and float64
    values."""
    findings: List[Finding] = []
    seen = set()
    f64: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            const = getattr(gm, node.target, None)
            if not isinstance(const, torch.Tensor) or id(const) in seen:
                continue
            seen.add(id(const))
            nb = _nbytes(const)
            if nb > const_bytes_limit:
                findings.append(Finding(
                    "error", "",
                    f"closure-captured constant {tuple(const.shape)} "
                    f"{_dtype_name(const.dtype)} ({nb / 2**20:.1f} MiB) "
                    "baked into the traced step: it re-uploads with every "
                    "compilation and pins HBM — thread it through "
                    "params/buffers/inputs instead", scope="jaxpr"))
        elif node.op == "call_function":
            val = node.meta.get("val")
            vals = val if isinstance(val, (tuple, list)) else (val,)
            if any(isinstance(v, torch.Tensor) and v.dtype == torch.float64
                   for v in vals):
                name = _op_name(node.target)
                f64[name] = f64.get(name, 0) + 1
    for op, n in sorted(f64.items()):
        findings.append(Finding(
            "warn", "",
            f"float64 values produced by {n} '{op}' op(s) in the "
            "traced step — a silent f32→f64 promotion doubles memory "
            "and leaves the accelerator fast path", scope="jaxpr"))
    return findings


def _leaves(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], f"{path}[{k!r}]"))
        return out
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def leaf_dtypes(trees: Dict[str, Dict]) -> Dict[str, Dict[str, torch.dtype]]:
    """``{tree name: {leaf path: dtype}}`` of the state trees."""
    return {name: {path: t.dtype for path, t in _leaves(tree)}
            for name, tree in trees.items()}


def leaf_dtype_findings(before: Dict[str, Dict[str, torch.dtype]],
                        after: Dict[str, Dict[str, torch.dtype]]
                        ) -> List[Finding]:
    """State leaves (params / opt_state / buffers) that the traced step
    hands back in another dtype than it took them in (the maps of
    :func:`leaf_dtypes`)."""
    findings = []
    for tree_name, leaves in before.items():
        outs = after.get(tree_name, {})
        for path, dt in leaves.items():
            new = outs.get(path)
            if new is not None and new != dt:
                findings.append(Finding(
                    "warn", "",
                    f"{tree_name} leaf {path} goes into the traced step "
                    f"as {_dtype_name(dt)} and comes back as "
                    f"{_dtype_name(new)}: the second step runs another "
                    "program on it (a silent retrace)", scope="jaxpr"))
    return findings


def dp_coverage_findings(param_keys: Sequence[str],
                         covered_keys: Sequence[str]) -> List[Finding]:
    """Param groups whose gradients escape the dp_overlap bucket plan
    (the JAX package's rule)."""
    missing = sorted(set(param_keys) - set(covered_keys))
    return [Finding(
        "error", "",
        f"gradient of param group {k!r} escapes the dp_overlap bucket "
        "plan: it would apply an unreduced per-device gradient and the "
        "replicas drift", scope="jaxpr") for k in missing]


def dp_findings(trainer) -> List[Finding]:
    """The bucket plan's coverage under ``dp_overlap = 1`` (the JAX
    package's ``_dp_findings``): an error for each param group outside
    every bucket, or an info line when a fallback gate keeps the
    implicit step."""
    if trainer.opts.dp_overlap != "1":
        return []
    if not trainer._dp_overlap_active():
        # 1F1B composes through its own plan (per-stage buckets reduced
        # over (pipe, data) at the cooldown ticks): its coverage instead
        pipe_plan = trainer._pipe_bucket_plan() \
            if trainer._pipelined else None
        if pipe_plan is not None:
            return dp_coverage_findings(
                list(trainer.params), [k for ks, _ in pipe_plan for k in ks])
        return [Finding(
            "info", "", "dp_overlap = 1 is configured but inactive on "
            "this build (see the fallback warning above); bucket "
            "coverage not checked", scope="jaxpr")]
    plan = trainer._dp_overlap_plan()
    covered: List[str] = list(plan.tail_keys)
    for ks in plan.stage_keys:
        covered.extend(ks)
    return dp_coverage_findings(list(trainer.params), covered)


class _TraceOnMeta(_OnMeta):
    """:class:`~..nnet.net._OnMeta` (factory calls that name a device
    make their tensor on ``meta``) that also drops a factory's
    ``generator``: the graph records a random draw as its op, and a
    generator object is not a value every torch version's tracer
    takes."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        return super().__torch_function__(func, types, args, kwargs)


def trace_step(trainer, audit: Optional[Dict] = None
               ) -> Tuple[torch.fx.GraphModule, Dict, Dict]:
    """Trace the meta-built trainer's train step (the trainer's own
    ``_loss_grads_outs`` + ``apply_update``, as ``update_step`` runs
    them) to one graph.  Params, optimizer state, buffers, the data,
    labels and extra inputs are the graph's inputs; a tensor the step
    reaches any other way is a graph constant.  Returns the graph and
    the state leaves' dtypes (:func:`leaf_dtypes`) that went into the
    step and that came back.  ``audit``, when given, gets what the SPMD
    lint reads (``analysis/spmdlint.py``): ``collectives``, the step's
    collective record in call order (``parallel.mesh.recording``), and
    ``donation``, which parameter and optimizer-state leaves the step
    handed back as the tensors it took in."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from ..parallel import mesh as meshlib
    if any(t.device.type != "meta" for g in trainer.params.values()
           for t in g.values()):
        raise ValueError("trace_step: the trainer must be built on meta "
                         "(init_model(torch.device('meta')))")
    trainer._ensure_opt_state()
    net = trainer.net
    meta = torch.device("meta")
    data = trainer.stage_input(torch.empty(net.node_shapes[0],
                                           device=meta))
    label = torch.empty((trainer.batch_size, trainer.netcfg.label_width()),
                        device=meta)
    extras = [torch.empty(net.node_shapes[1 + i], device=meta)
              for i in range(trainer.netcfg.extra_data_num)]
    before = leaf_dtypes({"params": trainer.params,
                          "opt_state": trainer.opt_state,
                          "buffers": trainer.buffers})
    after: Dict[str, Dict] = {}

    def step(params, opt_state, buffers, data, label, extras):
        took = {"params": _leaves(params), "opt_state": _leaves(opt_state)}
        saved = (trainer.params, trainer.opt_state, trainer.buffers)
        trainer.params, trainer.opt_state, trainer.buffers = \
            params, opt_state, buffers
        try:
            with _TraceOnMeta():
                inputs = {0: data}
                inputs.update({1 + i: e for i, e in enumerate(extras)})
                loss, grads, _, new_buffers = trainer._loss_grads_outs(
                    inputs, trainer.label_info(label), 0)
                trainer.apply_update(grads, 0)
            after.update(leaf_dtypes({"params": trainer.params,
                                      "opt_state": trainer.opt_state,
                                      "buffers": new_buffers}))
            if audit is not None:
                rows = []
                for tree, gave in (("params", trainer.params),
                                   ("opt_state", trainer.opt_state)):
                    out = dict(_leaves(gave))
                    for path, t in took[tree]:
                        rows.append({"tree": tree, "path": path,
                                     "bytes": _nbytes(t),
                                     "donated": out.get(path) is t})
                audit["donation"] = {
                    "source": "in-place", "leaves": rows,
                    "alias_bytes": sum(r["bytes"] for r in rows
                                       if r["donated"])}
            return loss, trainer.params, trainer.opt_state, new_buffers
        finally:
            trainer.params, trainer.opt_state, trainer.buffers = saved

    with meshlib.recording() as record:
        gm = make_fx(step)(trainer.params, trainer.opt_state,
                           trainer.buffers, data, label, extras)
    if audit is not None:
        audit["collectives"] = list(record)
    return gm, before, after


def lint_trainer(trainer, traced: Tuple = None) -> List[Finding]:
    """Lint the trainer's traced step (pass a :func:`trace_step` result
    to reuse it), closing with an ``info`` line of its node and constant
    counts."""
    gm, before, after = traced if traced is not None \
        else trace_step(trainer)
    findings = graph_findings(gm)
    findings.extend(leaf_dtype_findings(before, after))
    findings.extend(dp_findings(trainer))
    n_nodes = sum(1 for n in gm.graph.nodes
                  if n.op not in ("placeholder", "output"))
    n_consts = sum(1 for n in gm.graph.nodes if n.op == "get_attr"
                   and isinstance(getattr(gm, n.target, None),
                                  torch.Tensor))
    findings.append(Finding(
        "info", "", f"traced train step: {n_nodes} nodes, {n_consts} "
        "constants", scope="jaxpr"))
    return findings

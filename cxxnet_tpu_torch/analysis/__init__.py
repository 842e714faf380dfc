"""Static analysis: the config lint, the traced-graph lint and the SPMD
deep lint behind ``task = check`` (the JAX package's ``analysis/`` over
the port).

``run_check`` runs ``task = check`` (``main.py``).  Only the
dependency-free schema is imported here; the passes import the package
lazily, so ``layers/base.py`` (which imports :mod:`.schema` for its key
declarations) never cycles through this module.
"""

from __future__ import annotations

from typing import List, Tuple

from .schema import Finding, K, KeySpec  # noqa: F401 (re-export)


def run_check(cfg, path: str = "") -> Tuple[List[Finding], int]:
    """Lint an ordered config-pair list; returns (findings, exit code).

    The static config lint always runs.  When the config carries a
    ``netconfig`` block, the traced pass builds the configured trainer
    on ``meta`` tensors (no storage, no device work, at any width),
    traces its train step for the graph lint (``graph_lint.py``, the
    JAX package's jaxpr lint) and runs the OOM pre-flight (``mem_check
    = 1``) on it; a mesh config builds on a virtual mesh (one rank's
    shards, no process group).  The SPMD deep lint (``spmdlint.py``)
    walks the same trace unless ``spmd_check = 0``.  Exit code 1 iff any
    finding is an error."""
    from . import conflint
    findings = conflint.lint_pairs(cfg, path=path)
    has_net = any(k.startswith("layer[") for k, _ in cfg)
    if dict(cfg).get("mem_check", "0") == "1" and not has_net:
        findings.append(Finding(
            "warn", "mem_check",
            "the OOM pre-flight needs the traced-graph pass (it models "
            "the built net); this config has no netconfig block",
            scope="mem"))
    if not has_net:
        findings.append(Finding(
            "info", "", "no netconfig block in this config; "
            "traced-graph lint skipped", scope="jaxpr"))
    elif any(f.severity == "error" and "not ported to cxxnet_tpu_torch"
             in f.message for f in findings):
        findings.append(Finding(
            "info", "", "traced-graph pass skipped: the config uses what "
            "cxxnet_tpu_torch does not implement (errors above)",
            scope="jaxpr"))
    else:
        findings.extend(_trace_findings(
            cfg, spmd=dict(cfg).get("spmd_check", "1") == "1"))
    n_err = sum(1 for f in findings if f.severity == "error")
    return findings, (1 if n_err else 0)


def _trace_findings(cfg, spmd: bool = True) -> List[Finding]:
    """Build the configured trainer on ``meta``, lint its traced step
    (traced once: the graph lint and the SPMD lint walk the same trace)
    and run the pre-flight.  Build failures become findings instead of
    crashes: a config whose net cannot be built (bad shapes, undefined
    nodes) is what ``task = check`` exists to report.  The build changes
    no process state: the engine options are the trainer's own, and the
    log's silence and ``strict_config`` are put back."""
    import torch
    from ..layers import base as layer_base
    from ..monitor import log as mlog
    from ..nnet.trainer import NetTrainer
    from ..utils.config import ConfigError
    out: List[Finding] = []
    was_silent = mlog.is_silent()
    was_strict = layer_base.strict_config_enabled()
    net = NetTrainer()
    try:
        try:
            for k, v in cfg:
                # the build must not open the config's sink (a `run`
                # header for a run that never happens): task = check
                # writes its own `check` record
                if k == "metrics_sink":
                    continue
                net.set_param(k, v)
            net.set_param("silent", "1")
            net.init_model(torch.device("meta"))
        except (ConfigError, AssertionError, ValueError, KeyError) as e:
            return out + [Finding("error", "", f"net build failed: {e}",
                                  scope="jaxpr")]
        except Exception as e:  # noqa: BLE001 — environment, not config
            return out + [Finding(
                "warn", "", "traced-graph pass skipped: could not build "
                f"the net on meta tensors ({e})", scope="jaxpr")]
        traced, audit = None, {}
        try:
            from . import graph_lint
            traced = graph_lint.trace_step(net, audit)
            out.extend(graph_lint.lint_trainer(net, traced))
        except Exception as e:  # noqa: BLE001 — lint must not crash check
            out.append(Finding("warn", "", f"traced-graph lint failed: {e}",
                               scope="jaxpr"))
        try:
            from . import memmodel
            out.extend(memmodel.preflight(net, cfg))
        except Exception as e:  # noqa: BLE001 — lint must not crash check
            out.append(Finding("warn", "mem_check",
                               f"memory pre-flight failed: {e}",
                               scope="mem"))
        if spmd and traced is not None:
            try:
                from . import spmdlint
                out.extend(spmdlint.lint_trainer(net, traced, audit, cfg))
            except Exception as e:  # noqa: BLE001 — must not crash check
                out.append(Finding("warn", "spmd_check",
                                   f"SPMD lint failed: {e}", scope="spmd"))
        return out
    finally:
        mlog.set_silent(1 if was_silent else 0)
        if layer_base.strict_config_enabled() != was_strict:
            layer_base.set_strict_config(was_strict)
        net.metrics.close()

"""Config lint: unknown keys, value violations, cross-key constraints
(the JAX package's ``analysis/conflint.py`` over the port's keys).

The reference's config contract silently ignores unknown keys
(``layers/base.py`` Layer.set_param), so a typo'd ``dp_bucket_mb`` or a
misspelled layer key costs a full build-and-train cycle before anyone
notices.  ``lint_pairs`` walks an ordered config-pair list with the same
sectioning rules the runtime uses (``main._create_iterators`` for
``data``/``eval``/``pred`` blocks, ``NetConfig.configure`` for the
netconfig block) and checks every key against the declared-key registry:

* **unknown everywhere** → error with a did-you-mean suggestion;
* **known globally but not consumed here** (e.g. an ``img``-only key in
  an ``imgbin`` section) → warning, because the runtime will silently
  drop it;
* **value violations** → type/enum failures are errors, range
  excursions warnings (schema.check_value);
* **cross-key constraints** → the interaction rules the subsystems
  enforce with run-time warnings or silent fallbacks (dp_overlap
  vs batch_split/pipe, monitor vs multi_step, ...), surfaced before any
  device work;
* **not ported** → a config the port refuses at run time (a layer type
  of the JAX package that ``cxxnet_tpu_torch`` does not implement) is an
  error in the runtime's own words (:func:`_not_ported_rules`).

The findings and their words are the JAX package's, but for the
not-ported rules and the card's names (``mem_chip`` selects an H100, not
a TPU).  Structural netconfig problems (undefined nodes, shared-layer
params) are caught by running ``NetConfig.configure`` itself and
converting its exceptions into findings.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from . import registry
from .schema import Finding, check_value, did_you_mean

ConfigPairs = Sequence[Tuple[str, str]]

# structural sectioning keys handled by position, not by the registry
_SECTION_HEADS = {"data": 1, "eval": 2, "pred": 3}


def lint_pairs(pairs: ConfigPairs, path: str = "") -> List[Finding]:
    findings: List[Finding] = []
    flag = 0                      # 0 global, else inside data/eval/pred
    sect_name = ""
    sect: List[Tuple[str, str]] = []
    netcfg_mode = 0               # NetConfig.configure's state machine
    cur_layer: Optional[Tuple[str, str]] = None  # (type, name)
    layer_types: List[str] = []
    sections_seen: Dict[int, int] = {}

    for name, val in pairs:
        if flag != 0:
            if name in _SECTION_HEADS:
                findings.append(Finding(
                    "error", name, f"new {name!r} section opened before "
                    f"'iter = end' closed the {sect_name!r} section",
                    scope=f"iter:{sect_name}"))
                _lint_section(sect_name, sect, findings)
                flag, sect = _SECTION_HEADS[name], []
                sect_name = val if name == "eval" else name
                sections_seen[flag] = sections_seen.get(flag, 0) + 1
                continue
            if name == "iter" and val == "end":
                _lint_section(sect_name, sect, findings)
                flag, sect = 0, []
                continue
            sect.append((name, val))
            continue
        if name in _SECTION_HEADS:
            flag = _SECTION_HEADS[name]
            sect_name = val if name == "eval" else name
            sections_seen[flag] = sections_seen.get(flag, 0) + 1
            sect = []
            continue
        if name == "iter":
            findings.append(Finding(
                "error", name, "'iter = %s' outside a data/eval/pred "
                "section" % val))
            continue
        if name == "netconfig":
            if val not in ("start", "end"):
                findings.append(Finding(
                    "error", name, f"netconfig = {val!r}: expected start "
                    "or end"))
            netcfg_mode = 1 if val == "start" else 0
            cur_layer = None
            continue
        if name.startswith("layer["):
            cur_layer = _lint_layer_line(name, val, findings)
            if cur_layer is not None:
                layer_types.append(cur_layer[0])
            netcfg_mode = 2
            continue
        if netcfg_mode == 2 and cur_layer is not None:
            _lint_layer_key(cur_layer, name, val, findings)
            continue
        # global region (netcfg_mode 0 or 1, and layer lines the parser
        # rejected): the broadcast scope
        _lint_global_key(name, val, findings)

    if flag != 0:
        findings.append(Finding(
            "error", "iter", f"{sect_name!r} section never closed with "
            "'iter = end'", scope=f"iter:{sect_name}"))
        _lint_section(sect_name, sect, findings)

    findings.extend(_structural_findings(pairs))
    _cross_key_rules(pairs, layer_types, sections_seen, findings)
    return findings


# --------------------------------------------------------------- pieces
def _lint_global_key(name: str, val: str, findings: List[Finding]) -> None:
    scope = registry.global_scope()
    specs = scope.match(name)
    if not specs:
        sugg = did_you_mean(name, scope.names())
        findings.append(Finding(
            "error", name, "unknown config key (no layer, iterator, "
            "updater, engine, or task declares it); it would be silently "
            "ignored", suggestion=sugg, scope="global"))
        return
    _lint_value(specs, name, val, "global", findings)


def _lint_value(specs, name: str, val: str, scope_name: str,
                findings: List[Finding]) -> None:
    viols = []
    for sp in specs:
        v = check_value(sp, val)
        if v is None:
            return
        viols.append(v)
    sev, msg = viols[0]
    findings.append(Finding(sev, name, msg, scope=scope_name))


def _lint_section(sect_name: str, entries: ConfigPairs,
                  findings: List[Finding]) -> None:
    from ..io import factory
    scope_name = f"iter:{sect_name}"
    chain = tuple(v for k, v in entries if k == "iter")
    for t in chain:
        if factory.iter_stage_classes(t) is None and t != "end":
            findings.append(Finding(
                "error", "iter", f"unknown iterator type {t!r}",
                suggestion=did_you_mean(t, factory.iter_type_names()),
                scope=scope_name))
    scope = registry.iterator_scope(chain)
    for k, v in entries:
        if k == "iter":
            continue
        specs = scope.match(k)
        if specs:
            _lint_value(specs, k, v, scope_name, findings)
        elif registry.known_anywhere(k):
            findings.append(Finding(
                "warn", k, "not consumed by any stage of this iterator "
                f"chain ({'+'.join(chain) or 'empty'}); it will be "
                "silently ignored here", scope=scope_name))
        else:
            findings.append(Finding(
                "error", k, "unknown config key",
                suggestion=did_you_mean(
                    k, scope.names() or registry.global_scope().names()),
                scope=scope_name))


def _layer_type_known(tname: str) -> bool:
    """A type of the JAX package: the port's, and those it refuses by
    name (``moe``, ``torch``, ``pairtest-<master>-<slave>``: the
    not-ported rule reports them)."""
    from ..layers import registry as lreg
    if tname.startswith("pairtest-"):
        rest = tname[len("pairtest-"):]
        if "-" not in rest:
            return False
        master, slave = rest.split("-", 1)
        return _layer_type_known(master) and _layer_type_known(slave)
    return tname in lreg._REGISTRY or (tname in lreg.NOT_PORTED
                                       and tname != "pairtest")


def _lint_layer_line(name: str, val: str, findings: List[Finding]
                     ) -> Optional[Tuple[str, str]]:
    """Validate one ``layer[..] = type[:name]`` line; returns the
    (type, name) of the declared layer, or None when keys that follow
    should not be linted (shared/unparsable layers)."""
    from ..layers import registry as lreg
    from ..nnet.netconfig import _LAYER_ARROW, _LAYER_PLUS
    if _LAYER_PLUS.match(name) is None and _LAYER_ARROW.match(name) is None:
        findings.append(Finding(
            "error", name, "invalid layer declaration (expected "
            "layer[+N], layer[+N:tag], or layer[in->out])"))
        return None
    if val.startswith("share"):
        return None  # shared layer: params on it are a structural error
    tname, _, lname = val.partition(":")
    if not _layer_type_known(tname):
        findings.append(Finding(
            "error", name, f"unknown layer type {tname!r}",
            suggestion=did_you_mean(tname, lreg.layer_type_names())))
        return None
    return (tname, lname)


def _lint_layer_key(cur_layer: Tuple[str, str], name: str, val: str,
                    findings: List[Finding]) -> None:
    tname, lname = cur_layer
    scope_name = f"layer:{tname}" + (f":{lname}" if lname else "")
    if registry.layer_scope(tname) is None:
        return  # a type the port lacks: its error is the not-ported rule
    specs = registry.layer_key_match(tname, name)
    if specs:
        _lint_value(specs, name, val, scope_name, findings)
        return
    if registry.known_anywhere(name):
        findings.append(Finding(
            "warn", name, f"not consumed by layer type {tname!r}; it "
            "will be silently ignored here", scope=scope_name))
        return
    scope = registry.layer_scope(tname)
    findings.append(Finding(
        "error", name, "unknown config key",
        suggestion=did_you_mean(
            name, scope.names() or registry.global_scope().names()),
        scope=scope_name))


def _structural_findings(pairs: ConfigPairs) -> List[Finding]:
    """Run the real NetConfig parser: undefined input nodes, duplicate
    layer names, params on shared layers, malformed shapes."""
    from ..nnet.netconfig import NetConfig
    from ..utils.config import ConfigError
    if not any(k.startswith("layer[") for k, _ in pairs):
        return []  # no netconfig block (pred-from-checkpoint configs)
    try:
        NetConfig().configure(list(pairs))
    except (ConfigError, AssertionError) as e:
        return [Finding("error", "netconfig", f"net structure invalid: {e}")]
    except ValueError as e:
        return [Finding("error", "netconfig",
                        f"net structure invalid: {e}")]
    return []


# ------------------------------------------------------ cross-key rules
def _as_int(last: Dict[str, str], key: str, default: int = 0) -> int:
    try:
        return int(last.get(key, default))
    except ValueError:
        return default


def _as_float(last: Dict[str, str], key: str,
              default: float = 0.0) -> float:
    try:
        return float(last.get(key, default))
    except ValueError:
        return default


def _cross_key_rules(pairs: ConfigPairs, layer_types: List[str],
                     sections_seen: Dict[int, int],
                     findings: List[Finding]) -> None:
    last = dict(pairs)  # last occurrence wins, like sequential set_param
    task = "train"
    for k, v in pairs:
        if k == "task" and v != "check":
            task = v
    add = findings.append

    update_period = _as_int(last, "update_period", 1)
    multi_step = _as_int(last, "multi_step", 0)
    monitor = _as_int(last, "monitor", 0)
    batch_split = _as_int(last, "batch_split", 1)
    batch_size = _as_int(last, "batch_size", 0)

    if last.get("dp_overlap") == "1":
        if batch_split > 1 or _as_int(last, "remat", 0) > 0:
            add(Finding("warn", "dp_overlap",
                        "dp_overlap = 1 with batch_split/remat: these "
                        "paths schedule their own backward, so the run will "
                        "fall back to the implicit-psum step"))
        if "dp_reduce_at" in last and last["dp_reduce_at"] == "apply" \
                and update_period <= 1:
            add(Finding("warn", "dp_reduce_at",
                        "dp_reduce_at = apply has no effect without "
                        "update_period > 1 (there is only one reduce per "
                        "apply either way)"))
    elif "dp_reduce_dtype" in last:
        add(Finding("warn", "dp_reduce_dtype",
                    "dp_reduce_dtype only changes the wire dtype of the "
                    "explicit dp_overlap = 1 bucketed reduction; without "
                    "dp_overlap the key is silently ignored (the "
                    "implicit GSPMD psum reduces in the gradient dtype)"))
    _mesh_rules(last, layer_types, update_period, batch_size, add)
    if monitor and multi_step > 1:
        add(Finding("warn", "multi_step",
                    "monitor = 1 forces per-batch dispatch; multi_step "
                    f"= {multi_step} grouping will be disabled"))
    if multi_step > 1 and update_period > 1:
        add(Finding("warn", "multi_step",
                    "multi_step grouping requires update_period = 1; "
                    "the run will dispatch per batch"))
    if "monitor_nan" in last and not monitor:
        add(Finding("warn", "monitor_nan",
                    "the NaN/inf loss guard is only checked when "
                    "monitor = 1; monitor_nan has no effect here"))
    # --- observatory knobs (doc/monitor.md: prof_every / sentinel) ---
    prof_every = _as_int(last, "prof_every", 0)
    if prof_every > 0:
        if _as_int(last, "prof_start_step", -1) >= 0:
            add(Finding("warn", "prof_every",
                        "prof_every opens recurring round windows but "
                        "prof_start_step pins a one-shot step-addressed "
                        "window; prof_every will be ignored"))
        if not last.get("prof", ""):
            add(Finding("warn", "prof_every",
                        "prof_every has no effect without prof = <dir> "
                        "(no trace directory, no profiling windows)"))
        if monitor and multi_step > 1:
            add(Finding("warn", "prof_every",
                        "monitor = 1 disables multi_step grouped "
                        "dispatch, so every prof_every window will "
                        "profile per-batch dispatch — not the grouped "
                        "steady state the run would otherwise have"))
    sink_on = last.get("metrics_sink", "") not in ("", "none", "0")
    # host-side span tracing (doc/monitor.md): the trace_sample value
    # itself is bounds-checked by its KeySpec (int, 0..1e6); here only
    # the cross-key dependency — spans ride the JSONL sink
    if _as_int(last, "trace_sample", 0) > 0 and not sink_on:
        add(Finding("warn", "trace_sample",
                    "trace_sample > 0 without metrics_sink: span "
                    "records have nowhere to land, so the tracer stays "
                    "disarmed; set metrics_sink = jsonl:<path>"))
    if _as_int(last, "sentinel", 0):
        if not sink_on:
            add(Finding("warn", "sentinel",
                        "sentinel = 1 without metrics_sink: anomaly and "
                        "flight-recorder records have nowhere to land; "
                        "set metrics_sink = jsonl:<path>"))
    else:
        for k in ("sentinel_rel", "sentinel_warmup", "sentinel_ring"):
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without sentinel = 1"))
                break
    # goodput ledger (doc/monitor.md): default-on and silent when the
    # defaults apply — only an EXPLICIT setting that cannot take effect
    # is worth a finding
    if "ledger" in last:
        if _as_int(last, "ledger", 1) and not sink_on:
            add(Finding("warn", "ledger",
                        "ledger = 1 without metrics_sink: the "
                        "end-of-run goodput ledger record has nowhere "
                        "to land; set metrics_sink = jsonl:<path>"))
        if _as_int(last, "ledger", 1) and task not in ("train",
                                                       "finetune"):
            # ledger = 0 off-task is a harmless no-op, not a finding
            add(Finding("warn", "ledger",
                        f"ledger has no effect under task = {task}: "
                        "only train/finetune runs emit the end-of-run "
                        "ledger record"))
    if batch_split > 1 and batch_size and batch_size % batch_split:
        add(Finding("error", "batch_split",
                    f"batch_size = {batch_size} is not divisible by "
                    f"batch_split = {batch_split}"))
    pipe_mb = _as_int(last, "pipe_microbatch", 0)
    if pipe_mb > 0 and batch_size and batch_size % pipe_mb:
        add(Finding("error", "pipe_microbatch",
                    f"batch_size = {batch_size} is not divisible by "
                    f"pipe_microbatch = {pipe_mb}"))
    if "pipe_schedule" in last and not last.get("mesh"):
        add(Finding("warn", "pipe_schedule",
                    f"pipe_schedule = {last['pipe_schedule']} has no "
                    "effect without a mesh = ...,pipe:K axis"))
    if last.get("dtype") == "bfloat16" \
            and last.get("pallas_ln", "1") not in ("0", "x") \
            and any(t == "layernorm" or t.startswith("pairtest-")
                    and "layernorm" in t for t in layer_types):
        add(Finding("info", "pallas_ln",
                    "bf16 + pallas_ln: the output-derived layernorm "
                    "backward amplifies rounding for columns with "
                    "|beta| >> |gamma| (doc/pallas_ln.md); pallas_ln = x "
                    "is the input-saving escape hatch"))
    if _as_int(last, "continue", 0) and \
            last.get("model_in", "NULL") != "NULL":
        add(Finding("warn", "model_in",
                    "continue = 1 resumes from the newest snapshot; "
                    "model_in is ignored"))
    if task in ("train", "finetune") and sections_seen.get(1, 0) == 0:
        add(Finding("warn", "data",
                    f"task = {task} but the config has no 'data = ...' "
                    "iterator section (fine for bench/netconfig-only "
                    "configs; task = train will fail at init)"))
    if task in ("pred", "pred_raw", "extract", "serve"):
        if sections_seen.get(3, 0) == 0:
            add(Finding("error", "pred",
                        f"task = {task} requires a 'pred = <out>' "
                        "iterator section"
                        + (" (the request stream)"
                           if task == "serve" else "")))
        if last.get("model_in", "NULL") == "NULL":
            add(Finding("error", "model_in",
                        f"task = {task} requires model_in "
                        + ("(a model snapshot to serve)"
                           if task == "serve" else "")))
        if task == "extract" and not last.get("extract_node_name", ""):
            add(Finding("error", "extract_node_name",
                        "task = extract requires extract_node_name"))
    _serve_rules(last, task, add)
    _ckpt_rules(last, task, monitor, add)
    _text_rules(pairs, last, layer_types, add)
    _decode_rules(pairs, last, layer_types, task, add)
    _mem_rules(last, task, add)
    _not_ported_rules(pairs, add)


def _mem_rules(last: Dict[str, str], task: str, add) -> None:
    """Cross-key rules for the OOM pre-flight (doc/memory.md).  The
    pre-flight itself runs inside ``task=check``'s traced-graph pass
    (analysis/memmodel.py); these rules catch configurations where it
    silently models the wrong thing or nothing at all."""
    mem_check = last.get("mem_check", "0") == "1"
    if mem_check:
        if task not in ("train", "finetune"):
            add(Finding("warn", "mem_check",
                        f"the pre-flight models the TRAIN step's memory; "
                        f"task = {task} serves/predicts with a different "
                        "(smaller) footprint — the estimate does not "
                        "describe this run"))
        if _as_int(last, "remat", 0) > 1:
            add(Finding("info", "mem_check",
                        "remat > 1: the pre-flight assumes only "
                        "segment-boundary activations persist; the "
                        "allocator may keep more, so treat mem_margin_pct "
                        "as softer (doc/memory.md)"))
        from .costmodel import resolve_chip
        sel = last.get("mem_chip", "") or last.get("dev", "")
        if resolve_chip(sel) is None:
            add(Finding("warn", "mem_chip",
                        f"mem_check = 1 but mem_chip/dev = {sel!r} names "
                        "no known chip; the pre-flight has no HBM "
                        "capacity to check against (set mem_chip, e.g. "
                        "h100)"))
    else:
        for k in ("mem_margin_pct", "mem_chip"):
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without mem_check = 1"))
                break


def _ckpt_rules(last: Dict[str, str], task: str, monitor: int, add) -> None:
    """Cross-key rules for the checkpoint / rollback subsystem
    (doc/checkpoint.md).  ``continue = 1`` skipping partial/corrupt
    snapshots is runtime behavior documented in doc/checkpoint.md, not a
    lint rule — there is nothing to check statically."""
    rollback = _as_int(last, "rollback", 0)
    ckpt_keep = _as_int(last, "ckpt_keep", 3)
    if task not in ("train", "finetune"):
        for k in ("ckpt_async", "ckpt_keep", "rollback", "save_opt",
                  "ckpt_iter_state"):
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without task = "
                            "train/finetune (checkpoints are written by "
                            "the train loop)"))
                break
        return
    if rollback > 0:
        if not monitor or last.get("monitor_nan", "warn") != "fatal":
            add(Finding("warn", "rollback",
                        "rollback only triggers on TrainingDiverged, "
                        "which is raised by monitor_nan = fatal under "
                        "monitor = 1; with the current settings the "
                        "divergence is never raised and rollback never "
                        "runs"))
        if "model_dir" not in last:
            add(Finding("warn", "rollback",
                        "rollback restores snapshots from model_dir; "
                        "set it explicitly (the default './' litters the "
                        "working directory and is rarely intended)"))
        if _as_int(last, "save_model", 1) == 0:
            add(Finding("error", "rollback",
                        "rollback needs snapshots to restore, but "
                        "save_model = 0 disables them"))
        if _as_int(last, "save_opt", 1) == 0:
            add(Finding("info", "save_opt",
                        "save_opt = 0 with rollback: the restored run "
                        "restarts optimizer moments from zero, so the "
                        "retried window is not the checkpointed "
                        "trajectory"))
        if ckpt_keep < 2:
            add(Finding("warn", "ckpt_keep",
                        "ckpt_keep = 1 with rollback: if the newest "
                        "snapshot carries the divergence (or a kill "
                        "corrupts it) there is no older one to fall "
                        "back to; keep at least 2"))
    if "ckpt_keep" in last and _as_int(last, "ckpt_async", 0) == 0:
        add(Finding("warn", "ckpt_keep",
                    "ckpt_keep prunes NNNN.ckpt snapshot dirs, which "
                    "only ckpt_async = 1 writes; legacy .model files "
                    "are never pruned"))
    if "ckpt_iter_state" in last and _as_int(last, "save_model", 1) == 0:
        add(Finding("warn", "ckpt_iter_state",
                    "ckpt_iter_state has no effect with save_model = 0 "
                    "(no snapshots carry it)"))


def _serve_rules(last: Dict[str, str], task: str, add) -> None:
    """Cross-key rules for the serving subsystem (doc/serve.md).  The
    ``serve_shapes`` value itself (sorted/positive) is validated by its
    KeySpec check (serve.shapes_check), so a malformed spec is already
    an error before these rules run."""
    if task != "serve":
        for k in ("serve_shapes", "serve_max_batch", "serve_max_wait_ms",
                  "serve_dtype", "serve_clients", "serve_calib",
                  "serve_queue_depth", "serve_sentinel",
                  "serve_sentinel_window", "serve_admin_port",
                  "serve_slo_p99_ms", "serve_slo_avail",
                  "serve_slo_fast_sec", "serve_slo_slow_sec",
                  "serve_slo_fast_burn", "serve_slo_slow_burn",
                  "serve_flight_requests", "serve_flight_boost"):
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without task = serve"))
                break
        return
    if _as_int(last, "serve_sentinel", 0):
        if last.get("metrics_sink", "") in ("", "none", "0"):
            add(Finding("warn", "serve_sentinel",
                        "serve_sentinel = 1 without metrics_sink: "
                        "serve_window and anomaly records have nowhere "
                        "to land, so the sentinels disarm; set "
                        "metrics_sink = jsonl:<path>"))
    elif "serve_sentinel_window" in last:
        add(Finding("warn", "serve_sentinel_window",
                    "serve_sentinel_window has no effect without "
                    "serve_sentinel = 1"))
    if last.get("serve_dtype", "f32") == "int8" \
            and _as_int(last, "serve_calib", 0) <= 0:
        add(Finding("warn", "serve_dtype",
                    "serve_dtype = int8 without calibration batches "
                    "(serve_calib = N): the quantized variant ships "
                    "without its pairtest-vs-f32 error being measured "
                    "on real request data"))
    # -- live control plane (serve/admin.py, monitor/slo.py).  The
    # serve_admin_port RANGE is the KeySpec's lo/hi (0..65535, an
    # error at schema level); these rules cover the cross-key wiring.
    if _as_float(last, "serve_slo_p99_ms", 0.0) > 0.0 \
            and not _as_int(last, "serve_sentinel", 0):
        add(Finding("warn", "serve_slo_p99_ms",
                    "serve_slo_p99_ms without serve_sentinel = 1: the "
                    "SLO burn rates evaluate over the sentinel "
                    "reporter's serve_window stream, so the targets "
                    "are ignored"))
    win = _as_float(last, "serve_sentinel_window", 1.0)
    if win > 0:
        for k in ("serve_slo_fast_sec", "serve_slo_slow_sec"):
            if k not in last:
                continue
            sec = _as_float(last, k, 0.0)
            ratio = sec / win
            if sec > 0 and abs(ratio - round(ratio)) > 1e-9:
                add(Finding("error", k,
                            f"{k} = {sec:g} is not an integer multiple "
                            f"of serve_sentinel_window ({win:g}): the "
                            "burn window is a whole number of reporter "
                            "windows, so a fractional multiple "
                            "silently rounds"))
    fast = _as_float(last, "serve_slo_fast_sec", 60.0)
    slow = _as_float(last, "serve_slo_slow_sec", 600.0)
    if ("serve_slo_fast_sec" in last or "serve_slo_slow_sec" in last) \
            and fast >= slow:
        add(Finding("warn", "serve_slo_fast_sec",
                    f"serve_slo_fast_sec ({fast:g}) >= "
                    f"serve_slo_slow_sec ({slow:g}): the fast tier "
                    "should be the SHORTER window (acute outages), "
                    "the slow one the longer (simmering regressions)"))
    if ("serve_flight_requests" in last or "serve_flight_boost" in last) \
            and not _as_int(last, "serve_sentinel", 0):
        add(Finding("warn", "serve_flight_requests",
                    "serve_flight_* keys without serve_sentinel = 1: "
                    "flight capture triggers from sentinel anomalies "
                    "or SLO burns, which both ride the sentinel "
                    "reporter"))
    shapes_str = last.get("serve_shapes", "")
    if shapes_str:
        from ..serve import shapes_check
        if shapes_check(shapes_str) is None:
            buckets = [int(p) for p in shapes_str.split(",") if p.strip()]
            mb = _as_int(last, "serve_max_batch", 0)
            if mb > max(buckets):
                add(Finding("warn", "serve_max_batch",
                            f"serve_max_batch = {mb} exceeds the largest "
                            f"bucket ({max(buckets)}); coalescing caps at "
                            "the bucket and larger requests split across "
                            "dispatches"))


#: layer types that consume/produce (b, 1, s, d) sequence nodes — the
#: set the seq-mesh-axis rule checks for
_SEQ_LAYER_TYPES = ("attention", "embedding", "seq_fullc", "softmax_seq",
                    "moe")


def _text_rules(pairs: ConfigPairs, last: Dict[str, str],
                layer_types: List[str], add) -> None:
    """Cross-key rules for the tokenized text / packed-LM path
    (io/text.py, doc/io.md "Tokenized text datasets"):

    * a ``seq`` mesh axis with no sequence layer in the net warns (the
      axis shards nothing — devices replicate work);
    * the sequence length must divide by the ``seq`` axis, or attention
      falls back to dense with a full-sequence gather (runtime warns;
      surfaced here before any compile);
    * a ``packseq`` data section requires segment-aware consumers:
      ``softmax_seq`` without ``packed = 1`` trains on cross-document
      targets and ``attention`` without ``segment_key`` leaks
      cross-document scores — both errors;
    * the packer's ``seqlen`` must equal the netconfig input width.
    """
    from ..parallel.mesh import MeshSpec
    seq_ax = 1
    mesh_str = last.get("mesh", "")
    if mesh_str:
        try:
            seq_ax = MeshSpec.parse(mesh_str).axes.get("seq", 1)
        except ValueError:
            seq_ax = 1  # unparsable mesh: its own KeySpec's problem

    # scan sections for packseq chains + their seqlen; track the layer
    # keys that make packing safe (the same positional walk lint_pairs
    # does — sections must be skipped before layer keys are attributed)
    flag = 0
    pack_sections = []  # (section kind flag, seqlen value or None)
    cur_chain: List[str] = []
    cur_seqlen: Optional[str] = None
    # a seqlen OUTSIDE any section (file-global or CLI override) is
    # applied to the chain LAST by init_iterator's defcfg pass, so it
    # overrides every section's value — the lint must check the value
    # the runtime will actually use
    global_seqlen: Optional[str] = None
    cur_layer = ""
    n_attention = 0
    n_att_seg = 0
    softmax_seq_packed = False
    for name, val in pairs:
        if name in _SECTION_HEADS:
            flag = _SECTION_HEADS[name]
            cur_chain, cur_seqlen = [], None
            continue
        if flag:
            if name == "iter":
                if val == "end":
                    if "packseq" in cur_chain:
                        pack_sections.append(cur_seqlen)
                    flag = 0
                else:
                    cur_chain.append(val)
            elif name == "seqlen":
                cur_seqlen = val
            continue
        if name == "seqlen":
            global_seqlen = val
            continue
        if name.startswith("layer["):
            cur_layer = val.split(":", 1)[0]
            if cur_layer == "attention":
                n_attention += 1
            continue
        if cur_layer == "attention" and name == "segment_key" and val:
            n_att_seg += 1
        elif cur_layer == "softmax_seq" and name == "packed" \
                and val.strip() == "1":
            softmax_seq_packed = True
    if global_seqlen is not None:
        pack_sections = [global_seqlen for _ in pack_sections]

    has_seq_layer = any(t in _SEQ_LAYER_TYPES for t in layer_types)
    if seq_ax > 1 and layer_types and not has_seq_layer:
        add(Finding("warn", "mesh",
                    f"mesh = {mesh_str} carries a seq axis but the net "
                    "has no sequence layer (attention/embedding/"
                    "seq_fullc): the axis shards nothing and its devices "
                    "replicate work"))
    # sequence length divisibility: the packer's seqlen and the
    # netconfig input width both shard over the seq axis
    in_shape = last.get("input_shape", "")
    in_width = None
    if in_shape:
        try:
            in_width = int(in_shape.split(",")[-1])
        except ValueError:
            pass  # malformed input_shape: NetConfig's structural error
    seqlens = []  # one entry PER packseq section — a mismatch in any
    for sl in pack_sections:  # section must surface, not just the last
        if sl is not None:
            try:
                seqlens.append(int(sl))
            except ValueError:
                pass  # type error already reported by the KeySpec
    if seq_ax > 1 and has_seq_layer:
        for key, w in ([("input_shape", in_width)]
                       if in_width is not None else []) \
                + [("seqlen", w) for w in seqlens]:
            if w % seq_ax:
                add(Finding("warn", key,
                            f"sequence length {w} is not divisible by "
                            f"the seq mesh axis ({seq_ax}); attention "
                            "falls back to dense and gathers the full "
                            "sequence on one device"))
                break
    if not pack_sections or not layer_types:
        return
    if in_width is not None:
        for w in seqlens:
            if w != in_width:
                add(Finding("error", "seqlen",
                            f"packseq seqlen = {w} but the netconfig "
                            f"input width is {in_width}; the packed "
                            "rows will not fit the input node"))
                break
    if not softmax_seq_packed and "softmax_seq" in layer_types:
        add(Finding("error", "packed",
                    "packseq data section but softmax_seq has no "
                    "'packed = 1': cross-document and padding targets "
                    "would train as real next-token targets; set "
                    "packed = 1 on the loss layer (doc/io.md)"))
    if n_attention and n_att_seg < n_attention:
        add(Finding("error", "segment_key",
                    f"packseq data section but {n_attention - n_att_seg} "
                    f"of {n_attention} attention layer(s) have no "
                    "segment_key: cross-document attention leaks across "
                    "packed rows; set segment_key = <segment field> "
                    "(doc/io.md)"))


#: keys the incremental-decode path consumes (serve/decode.py); the
#: first one present off-task carries the "no effect" warn
_DECODE_KEYS = ("serve_gen", "decode_slots", "decode_max_seqlen",
                "serve_gen_tokens", "serve_gen_sample", "serve_gen_temp",
                "serve_gen_topk", "serve_gen_seed", "serve_gen_eos",
                "serve_gen_prompt", "serve_gen_batching",
                "serve_draft_model", "spec_k", "decode_prefill_chunk",
                "decode_kv_dtype")


def _decode_rules(pairs: ConfigPairs, last: Dict[str, str],
                  layer_types: List[str], task: str, add) -> None:
    """Cross-key rules for KV-cache incremental decode (serve/decode.py,
    doc/serve.md "Incremental decode"):

    * decode/generation keys without ``task = serve`` warn (first
      match), and ``decode_*``/``serve_gen_*`` detail keys without
      ``serve_gen = 1`` warn — they configure a path that never runs;
    * ``serve_gen = 1`` needs an LM netconfig — embedding + attention +
      softmax_seq — and every attention layer ``causal = 1`` (the cache
      is append-only; a bidirectional layer would need future
      positions);
    * ``decode_max_seqlen`` must equal the netconfig input width (the
      prefill executable runs the net at its declared width) and any
      packseq ``seqlen`` — both mismatches are errors before a compile;
    * the KV cache (2 x layers x slots x seqlen x dim x dtype) over the
      selected chip's HBM capacity is the same pre-flight rejection
      ``task=check``'s memory pass makes for train steps (doc/memory.md)
      — surfaced analytically here, no trace needed;
    * sampling detail keys that the selected ``serve_gen_sample`` kind
      ignores warn;
    * speculative decoding: ``spec_k`` without ``serve_draft_model``
      errors, a missing draft snapshot errors at check time (info when
      ``model_in`` is missing too — an untrained example tree), a draft
      with ``spec_k = 0`` warns, and non-greedy sampling + speculation
      gets the rejection-sampling reproducibility note;
    * ``decode_prefill_chunk`` that does not divide the cache length
      warns (the last chunk pads dead columns).
    """
    gen = _as_int(last, "serve_gen", 0)
    if task != "serve":
        for k in _DECODE_KEYS:
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without task = serve"))
                break
        return
    if not gen:
        for k in _DECODE_KEYS[1:]:
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect without serve_gen = 1"))
                break
        return
    # --- LM netconfig structure: walk the layer keys positionally (the
    # _text_rules discipline) for causal flags and the embedding dim
    cur_layer = ""
    n_attention = 0
    n_causal = 0
    embed_dim = None
    for name, val in pairs:
        if name.startswith("layer["):
            cur_layer = val.split(":", 1)[0]
            if cur_layer == "attention":
                n_attention += 1
            continue
        if cur_layer == "attention" and name == "causal" \
                and val.strip() == "1":
            n_causal += 1
        elif cur_layer == "embedding" and name == "nhidden":
            try:
                embed_dim = int(val)
            except ValueError:
                pass  # type error already reported by the KeySpec
    missing = [t for t in ("embedding", "attention", "softmax_seq")
               if t not in layer_types]
    if layer_types and missing:
        add(Finding("error", "serve_gen",
                    "serve_gen = 1 needs an LM netconfig but the net "
                    f"has no {'/'.join(missing)} layer(s); incremental "
                    "decode only speaks token-id transformers "
                    "(doc/serve.md)"))
        return
    if n_attention and n_causal < n_attention:
        add(Finding("error", "causal",
                    f"serve_gen = 1 but {n_attention - n_causal} of "
                    f"{n_attention} attention layer(s) are not "
                    "causal = 1: the KV cache is append-only, so "
                    "bidirectional attention cannot decode "
                    "incrementally"))
    # --- cache geometry vs the declared input width / packseq seqlen
    in_width = None
    in_shape = last.get("input_shape", "")
    if in_shape:
        try:
            in_width = int(in_shape.split(",")[-1])
        except ValueError:
            pass
    max_seqlen = _as_int(last, "decode_max_seqlen", 0)
    if max_seqlen:
        if in_width is not None and max_seqlen != in_width:
            add(Finding("error", "decode_max_seqlen",
                        f"decode_max_seqlen = {max_seqlen} but the "
                        f"netconfig input width is {in_width}; the "
                        "prefill executable runs the net at its "
                        "declared width, so the two must match"))
        sl = _as_int(last, "seqlen", 0)
        if sl and max_seqlen != sl:
            add(Finding("error", "decode_max_seqlen",
                        f"decode_max_seqlen = {max_seqlen} but the "
                        f"packer's seqlen is {sl}; prompts tokenized "
                        "at one length cannot fill a cache sized for "
                        "another"))
    # --- KV-cache HBM pre-flight (doc/memory.md): the analytic bytes
    # the live engine's footprint() reports, checked against the
    # selected chip's capacity without tracing anything
    eff_seqlen = max_seqlen or in_width
    if n_attention and embed_dim and eff_seqlen:
        from .costmodel import HBM_BYTES, resolve_chip
        chip = resolve_chip(last.get("mem_chip", "")
                            or last.get("dev", ""))
        if chip is not None:
            cap = HBM_BYTES[chip]
            slots = _as_int(last, "decode_slots", 4)
            itemsize = 2 if last.get("dtype", "") == "bfloat16" else 4
            kv = 2 * n_attention * slots * eff_seqlen * embed_dim \
                * itemsize
            if kv > cap:
                add(Finding("error", "decode_slots",
                            f"KV cache needs {kv / 1e9:.2f} GB "
                            f"({slots} slot(s) x {eff_seqlen} positions "
                            f"x {n_attention} attention layer(s) x dim "
                            f"{embed_dim}) but {chip} holds "
                            f"{cap / 1e9:.1f} GB HBM — before weights; "
                            "shrink decode_slots or decode_max_seqlen "
                            "(doc/memory.md)"))
    # --- sampling knob consistency
    kind = last.get("serve_gen_sample", "greedy")
    if kind == "greedy":
        for k in ("serve_gen_temp", "serve_gen_topk"):
            if k in last:
                add(Finding("warn", k,
                            f"{k} has no effect under serve_gen_sample "
                            "= greedy (argmax ignores it)"))
                break
    elif kind == "temperature" and "serve_gen_topk" in last:
        add(Finding("warn", "serve_gen_topk",
                    "serve_gen_topk has no effect under "
                    "serve_gen_sample = temperature; set "
                    "serve_gen_sample = topk"))
    elif kind == "topk" and "serve_gen_topk" not in last:
        add(Finding("warn", "serve_gen_sample",
                    "serve_gen_sample = topk without serve_gen_topk: "
                    "the cutoff defaults to the full vocabulary "
                    "(plain temperature sampling)"))
    # --- speculative decoding + chunked prefill (doc/serve.md)
    spec_k = _as_int(last, "spec_k", 0)
    draft = last.get("serve_draft_model", "")
    if spec_k >= 1 and not draft:
        add(Finding("error", "spec_k",
                    f"spec_k = {spec_k} without serve_draft_model: "
                    "speculation needs a draft snapshot to propose "
                    "tokens (doc/serve.md)"))
    if draft:
        if not os.path.exists(draft):
            model_in = last.get("model_in", "NULL")
            have_flagship = model_in != "NULL" \
                and os.path.exists(model_in)
            # an example tree checked in without trained weights lints
            # the conf shape, not the filesystem: downgrade when the
            # flagship snapshot is missing too
            sev = "error" if have_flagship else "info"
            add(Finding(sev, "serve_draft_model",
                        f"draft snapshot {draft!r} does not exist"
                        + ("" if have_flagship else
                           " (neither does model_in — train both "
                           "before serving)")))
        if spec_k < 1:
            add(Finding("warn", "serve_draft_model",
                        "serve_draft_model configured but spec_k is "
                        f"{spec_k}: the draft loads for nothing — "
                        "speculation stays off without spec_k >= 1"))
        elif kind != "greedy":
            add(Finding("info", "spec_k",
                        f"speculation under serve_gen_sample = {kind} "
                        "uses rejection sampling off the verified "
                        "distribution — the output law matches plain "
                        "sampling but the token stream is not "
                        "reproducible against a non-speculative run "
                        "(greedy is bitwise-identical; doc/serve.md)"))
    chunk = _as_int(last, "decode_prefill_chunk", 0)
    if chunk and eff_seqlen and eff_seqlen % chunk:
        add(Finding("warn", "decode_prefill_chunk",
                    f"decode_prefill_chunk = {chunk} does not divide "
                    f"the cache length ({eff_seqlen}): the last chunk "
                    "of a full-length prompt pads dead columns — pick "
                    "a divisor to keep every chunk dispatch full"))


def _mesh_rules(last: Dict[str, str], layer_types: List[str],
                update_period: int, batch_size: int, add) -> None:
    """Cross-key rules for the first-class ``mesh`` key: axis product vs
    the device selection, batch divisibility by the data axis, the
    dp_overlap x mesh combinations (surfaced at check time instead of as
    the trainer's trace-time warn-once fallback), and a dead model axis.
    Unknown axis NAMES are value errors handled by the ``mesh`` KeySpec
    check (MeshSpec.parse with did-you-mean), so a spec that fails to
    parse is skipped here — the error is already reported."""
    mesh_str = last.get("mesh", "")
    if not mesh_str:
        return
    from ..parallel.mesh import MeshSpec, parse_device_spec
    try:
        axes = MeshSpec.parse(mesh_str).axes
    except ValueError:
        return
    total = 1
    for v in axes.values():
        total *= v
    dev = last.get("dev", "")
    ids = None
    if dev:
        try:
            ids = parse_device_spec(dev)["ids"]
        except (ValueError, IndexError):
            ids = None  # malformed dev: its own KeySpec's problem
    if ids is not None and len(ids) != total:
        add(Finding("error", "mesh",
                    f"mesh = {mesh_str} needs {total} device(s) (axis "
                    f"product) but dev = {dev} selects {len(ids)}"))
    ndata = axes.get("data", 1)
    if batch_size and ndata > 1 and batch_size % ndata:
        add(Finding("error", "mesh",
                    f"batch_size = {batch_size} is not divisible by the "
                    f"data axis ({ndata}); the batch shards over it"))
    if axes.get("model", 1) > 1 and last.get("fullc_gather", "0") != "1" \
            and "moe" not in layer_types:
        add(Finding("info", "mesh",
                    "the model axis shards nothing here (fullc_gather = 0 "
                    "and no moe layer): model-axis devices replicate "
                    "work; set fullc_gather = 1 to shard fullc weights"))
    # pipeline-axis rules (ahead of the 1F1B graduation, ROADMAP item 5):
    # a pipe axis needs a net deep enough to cut into that many stages —
    # layer count is the static proxy for stage-able boundaries
    npipe = axes.get("pipe", 1)
    if npipe > 1:
        if not layer_types:
            add(Finding("warn", "mesh",
                        f"mesh = {mesh_str} carries a pipe axis of "
                        f"{npipe} stages but the config has no netconfig "
                        "block: there is nothing to cut into stages"))
        elif len(layer_types) < npipe:
            add(Finding("warn", "mesh",
                        f"mesh = {mesh_str} asks for {npipe} pipeline "
                        f"stages but the net declares only "
                        f"{len(layer_types)} layer(s); stages would sit "
                        "empty — shrink the pipe axis or deepen the net"))
        pipe_mb = _as_int(last, "pipe_microbatch", 0)
        n_micro = pipe_mb or 2 * npipe
        if n_micro % npipe:
            add(Finding("error", "pipe_microbatch",
                        f"pipe_microbatch = {n_micro} is not divisible "
                        f"by the pipe axis ({npipe}): the schedule "
                        "staggers one microbatch per stage, so ragged "
                        "counts leave permanent extra bubble ticks — "
                        "use a multiple of the axis"))
        if pipe_mb == 0 and batch_size and batch_size % n_micro:
            # the explicit-pipe_microbatch case is the keyed
            # divisibility error above (lint_pairs); this covers the
            # DEFAULTED count 2*S the trainer will actually use
            add(Finding("error", "pipe_microbatch",
                        f"batch_size = {batch_size} is not divisible by "
                        f"the defaulted pipe_microbatch = {n_micro} "
                        f"(2x the pipe axis); set pipe_microbatch "
                        "explicitly or pad the batch"))
        if _as_int(last, "remat", 0):
            add(Finding("info", "remat",
                        "remat with a pipe axis: the trainer rejects "
                        "the combination — the pipeline schedule "
                        "already recomputes each stage's forward "
                        "inside its backward tick, so remat would "
                        "recompute twice; drop remat"))
    elif "pipe_schedule" in last:
        add(Finding("warn", "pipe_schedule",
                    f"pipe_schedule = {last['pipe_schedule']} has no "
                    f"effect: mesh = {mesh_str} carries no pipe axis "
                    "wider than 1"))
    if last.get("dp_overlap") != "1":
        return
    extra_ax = [a for a, s in axes.items()
                if a not in ("data", "model") and s > 1]
    if "pipe" in extra_ax:
        # pipe_schedule = 1f1b COMPOSES with dp_overlap (bucketed
        # (pipe, data) psums at cooldown grad-ready ticks) — no finding;
        # only the gpipe fill-drain, whose backward is autodiff-
        # scheduled, still takes the trainer's warn-once fallback
        if last.get("pipe_schedule", "gpipe") != "1f1b":
            add(Finding("info", "dp_overlap",
                        "dp_overlap = 1 with the gpipe pipeline "
                        "schedule: its backward is autodiff-scheduled, "
                        "so the trainer keeps the implicit-psum step; "
                        "set pipe_schedule = 1f1b to compose bucketed "
                        "reductions with the pipe axis "
                        "(doc/multichip.md)"))
        extra_ax = [a for a in extra_ax if a != "pipe"]
    if extra_ax:
        add(Finding("warn", "dp_overlap",
                    f"dp_overlap = 1 with mesh axes {'/'.join(extra_ax)}: "
                    "ring-attention/expert/pipeline collectives are "
                    "GSPMD-placed, so the run will fall back to the "
                    "implicit-psum step"))
    elif ndata < 2:
        add(Finding("warn", "dp_overlap",
                    f"dp_overlap = 1 but mesh = {mesh_str} has no data "
                    "axis wider than 1; there is nothing to reduce and "
                    "the run falls back to the implicit step"))
    elif axes.get("model", 1) > 1 and "moe" in layer_types:
        add(Finding("warn", "dp_overlap",
                    "dp_overlap = 1 with a moe layer on a model mesh "
                    "axis: the model axis hosts the experts and their "
                    "dispatch/combine all-to-alls are GSPMD-placed, so "
                    "the run will fall back to the implicit-psum step"))
    elif axes.get("model", 1) > 1 \
            and last.get("dp_reduce_at", "apply") == "apply" \
            and update_period > 1:
        add(Finding("info", "dp_reduce_at",
                    "dp_reduce_at = apply is pure-DP; the model mesh "
                    "axis reduces every micro-step instead "
                    "(dp_reduce_at = step semantics)"))


# --------------------------------------------------- not-ported rules
def _not_ported_rules(pairs: ConfigPairs, add) -> None:
    """A config the port would refuse at run time is an error, in the
    runtime's own words: a layer type of ``layers/registry.NOT_PORTED``."""
    from ..layers import registry as lreg
    for name, val in pairs:
        if name.startswith("layer[") and not val.startswith("share"):
            tname = val.partition(":")[0]
            if lreg.is_not_ported(tname) and _layer_type_known(tname):
                add(Finding("error", name, lreg.not_ported_message(tname)))


# ----------------------------------------------- strict_config reporting
_reported: set = set()


def report_ignored_layer_key(layer, name: str, val: str) -> None:
    """``strict_config = 1`` hook (``layers/base.py``): a key reached the
    base set_param unconsumed.  Silent when the layer type declares it
    (subclasses that consume a key and still call super) or when any
    subsystem declares it (globals are broadcast to every layer); warns
    once per (type, key) otherwise."""
    if name in _SECTION_HEADS or name in ("iter", "netconfig") \
            or name.startswith("layer["):
        return  # sectioning keys are consumed structurally, not by scopes
    tname = layer.type_names[0] if layer.type_names else type(layer).__name__
    if (tname, name) in _reported:
        return
    if registry.layer_key_match(tname, name):
        return
    if registry.layer_scope(tname) is None or registry.known_anywhere(name):
        return
    _reported.add((tname, name))
    from ..monitor import log as mlog
    scope = registry.layer_scope(tname)
    sugg = did_you_mean(name, scope.names())
    mlog.warn(
        f"strict_config: layer {layer.name or tname!s} ({tname}) ignores "
        f"unknown key {name!r}"
        + (f" (did you mean {sugg!r}?)" if sugg else ""))

"""Serving: ``task = serve``.

* :class:`~cxxnet_tpu_torch.serve.engine.PredictEngine` — pinned-shape
  predict: every request pads up to the nearest declared batch bucket
  (``serve_shapes``); ``serve_dtype`` selects the f32 / bf16 /
  per-channel-int8 weight variants.
* :class:`~cxxnet_tpu_torch.serve.batcher.MicroBatcher` — a bounded
  request queue and one dispatcher thread that coalesces concurrent
  client requests into bucket dispatches.
* ``serve_gen = 1``: KV-cached incremental decode (:mod:`.decode`)
  behind the token-level continuous-batching step scheduler
  (:class:`~cxxnet_tpu_torch.serve.batcher.StepScheduler`), with
  speculative decoding (``serve_draft_model`` + ``spec_k``), chunked
  prefill (``decode_prefill_chunk``) and a KV-cache dtype of its own
  (``decode_kv_dtype``).
* :mod:`.host` — engine + batcher bundles (``ServeModel``, ``GenModel``)
  routed by model name (``ModelHost``), which owns the admin endpoint.
* :mod:`.admin` — ``serve_admin_port``: ``/metrics`` (Prometheus text),
  ``/healthz``, ``/readyz``, ``/statusz``; and the flight capture
  (``serve_flight_*``) that a serve sentinel's anomaly
  (``serve_sentinel*``, over the reporter's ``serve_window`` records)
  or an SLO burn (``serve_slo_*``, :mod:`..monitor.slo`) arms.

:class:`ServeConfig` parses the same ``serve_*`` / ``decode_*`` keys as
the JAX package, plus one of the port's own: ``serve_gen_prompt_doc =
1`` makes every document of a ``packseq`` prompt row its own request
(its first ``serve_gen_prompt`` ids), so prompts keep their own lengths;
the default ``0`` takes each row's leading ``serve_gen_prompt`` ids, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..analysis.schema import K


def parse_shapes(val: str) -> List[int]:
    """Parse a ``serve_shapes`` spec ("1,8,32"); raises ValueError with
    the message :func:`shapes_check` gives."""
    msg = shapes_check(val)
    if msg is not None:
        raise ValueError(f"serve_shapes = {val!r}: {msg}")
    return [int(p) for p in val.split(",") if p.strip()]


def shapes_check(val: str) -> Optional[str]:
    """Validator for ``serve_shapes``: the buckets must be positive,
    strictly ascending ints (None when they are)."""
    try:
        parts = [int(p) for p in val.split(",") if p.strip()]
    except ValueError:
        return "expected comma-separated batch-size buckets, e.g. 1,8,32"
    if not parts:
        return "expected at least one batch-size bucket"
    if any(p <= 0 for p in parts):
        return "buckets must be positive"
    if sorted(set(parts)) != parts:
        return "buckets must be strictly ascending (sorted, no duplicates)"
    return None


#: config keys the serving subsystem consumes (ServeConfig.from_pairs);
#: merged into main.TASK_KEYS so the declared-key registry and the
#: cross-key rules of ``task = check`` see them
SERVE_KEYS = (
    K("serve_shapes", "str", check=shapes_check,
      help="pinned batch-size buckets, ascending (requests pad up to "
           "the nearest; one pre-lowered executable each)"),
    K("serve_max_batch", "int", lo=1,
      help="coalesce at most this many rows per dispatch "
           "(0/unset = the largest bucket)"),
    K("serve_max_wait_ms", "float", lo=0.0,
      help="max time the batcher holds a request open for coalescing"),
    K("serve_dtype", "enum", choices=("f32", "bf16", "int8"),
      help="predict variant: f32 reference, bf16 cast, or per-channel "
           "int8 weights for fullc/conv (doc/serve.md)"),
    K("serve_clients", "int", lo=1,
      help="task=serve: concurrent client threads replaying the pred "
           "iterator as single-row requests"),
    K("serve_calib", "int", lo=0,
      help="pairtest the quantized variant against f32 on this many "
           "request batches at startup (serve_dtype != f32)"),
    K("serve_queue_depth", "int", lo=1,
      help="bounded request-queue depth (backpressure past it)"),
    K("serve_sentinel", "int", lo=0, hi=1,
      help="serve-side EWMA regression sentinels (p99 rise / QPS drop "
           "/ queue-depth rise) over windowed serve_window records; "
           "needs metrics_sink (doc/serve.md)"),
    K("serve_sentinel_window", "float", lo=0.01,
      help="seconds per sentinel observation window (the reporter "
           "thread's cadence)"),
    # -- incremental decode / generation (serve/decode.py, doc/serve.md)
    K("serve_gen", "int", lo=0, hi=1,
      help="task=serve: autoregressive generation through the KV-cache "
           "decode engine instead of batch predict (LM netconfigs)"),
    K("decode_slots", "int", lo=1,
      help="in-flight decode batch: cache rows the step executable "
           "carries (token-level continuous batching keeps them full)"),
    K("decode_max_seqlen", "int", lo=1,
      help="KV-cache length per slot; must equal the netconfig input "
           "width (the prefill executable runs the net at its declared "
           "width).  Unset = the input width"),
    K("serve_gen_tokens", "int", lo=1,
      help="max new tokens generated per request"),
    K("serve_gen_sample", "enum",
      choices=("greedy", "temperature", "topk"),
      help="sampling off the LM head: greedy argmax (deterministic), "
           "temperature softmax, or top-k restricted"),
    K("serve_gen_temp", "float", lo=1e-6,
      help="softmax temperature for temperature/topk sampling"),
    K("serve_gen_topk", "int", lo=1,
      help="top-k cutoff for serve_gen_sample = topk"),
    K("serve_gen_seed", "int", lo=0,
      help="per-request deterministic sampling seed"),
    K("serve_gen_eos", "int", lo=-1,
      help="stop token id (-1 = never; generation runs to "
           "serve_gen_tokens or the cache end)"),
    K("serve_gen_prompt", "int", lo=1,
      help="task=serve: prompt length taken from each pred-iterator "
           "row's leading token ids"),
    K("serve_gen_prompt_doc", "int", lo=0, hi=1,
      help="task=serve: every document of a packseq prompt row is its "
           "own request (its first serve_gen_prompt ids)"),
    K("serve_gen_batching", "enum", choices=("continuous", "request"),
      help="continuous = requests join/leave the decode batch between "
           "steps; request = fill a batch and run it to completion "
           "(the A/B baseline)"),
    # -- speculative decoding + chunked prefill (doc/serve.md)
    K("serve_draft_model", "path",
      help="snapshot of the small DRAFT net for speculative decoding "
           "(loaded through the load_serve_model path; same vocab and "
           "decode_max_seqlen as the flagship)"),
    K("spec_k", "int", lo=0,
      help="draft tokens proposed per speculative round; the flagship "
           "verifies all spec_k+1 positions in ONE block dispatch "
           "(0 = speculation off; requires serve_draft_model)"),
    K("decode_prefill_chunk", "int", lo=0,
      help="chunked prefill: stream the prompt into the KV cache this "
           "many columns per dispatch, interleaved between decode "
           "rounds (0 = whole-prompt prefill)"),
    K("decode_kv_dtype", "enum", choices=("f32", "bf16"),
      help="KV-cache storage dtype: bf16 halves the dominant serve "
           "memory term (cast on write, f32 accumulation on read; "
           "pairtested within SERVE_TOL)"),
    # -- live control plane (serve/admin.py, doc/serve.md "Operating a
    #    serve host")
    K("serve_admin_port", "int", lo=0, hi=65535,
      help="in-process admin HTTP endpoint (/metrics /healthz /readyz "
           "/statusz) on this port; 0 = off (the range check IS the "
           "lint: 1-65535 to enable)"),
    K("serve_slo_p99_ms", "float", lo=0.0,
      help="latency SLO threshold: requests slower than this spend "
           "error budget (monitor/slo.py); 0 = SLO off"),
    K("serve_slo_avail", "float", lo=0.0, hi=1.0,
      help="fraction of requests that must meet serve_slo_p99_ms "
           "(budget = 1 - avail); must be < 1.0 when the SLO is on"),
    K("serve_slo_fast_sec", "float", lo=0.01,
      help="fast burn window seconds (acute outage tier); must be an "
           "integer multiple of serve_sentinel_window"),
    K("serve_slo_slow_sec", "float", lo=0.01,
      help="slow burn window seconds (simmering regression tier); "
           "must be an integer multiple of serve_sentinel_window"),
    K("serve_slo_fast_burn", "float", lo=1e-6,
      help="fast-tier firing threshold (budget-spend velocity; 14.4 "
           "= a 30-day budget gone in 2 days)"),
    K("serve_slo_slow_burn", "float", lo=1e-6,
      help="slow-tier firing threshold"),
    K("serve_flight_requests", "int", lo=1,
      help="anomaly flight capture: boost trace_sample for this many "
           "requests before dumping the serve_flight record"),
    K("serve_flight_boost", "int", lo=1,
      help="trace_sample value while a flight capture is armed (1 = "
           "trace every request)"),
)


@dataclasses.dataclass
class ServeConfig:
    shapes: Tuple[int, ...] = (1, 8, 32)
    max_batch: int = 0          # 0 = the largest bucket
    max_wait_ms: float = 2.0
    dtype: str = "f32"
    clients: int = 4
    calib: int = 0
    queue_depth: int = 64
    # incremental decode / generation (serve/decode.py)
    gen: int = 0
    slots: int = 4
    max_seqlen: int = 0         # 0 = the netconfig input width
    gen_tokens: int = 32
    gen_sample: str = "greedy"
    gen_temp: float = 1.0
    gen_topk: int = 0
    gen_seed: int = 0
    gen_eos: int = -1
    gen_prompt: int = 8
    gen_prompt_doc: int = 0
    gen_batching: str = "continuous"
    # speculative decoding + chunked prefill (serve/batcher.py)
    draft_model: str = ""       # draft-net snapshot; "" = no speculation
    spec_k: int = 0             # proposals per round; 0 = speculation off
    prefill_chunk: int = 0      # 0 = whole-prompt prefill
    kv_dtype: str = ""          # "" = the net's dtype
    # serve-side sentinels (the reporter's serve_window records)
    sentinel: int = 0
    sentinel_window: float = 1.0
    # the admin endpoint (serve/admin.py) and the SLO (monitor/slo.py)
    admin_port: int = 0         # 0 = no admin endpoint
    slo_p99_ms: float = 0.0     # 0 = no SLO
    slo_avail: float = 0.999
    slo_fast_sec: float = 60.0
    slo_slow_sec: float = 600.0
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 6.0
    flight_requests: int = 16
    flight_boost: int = 1

    def __post_init__(self):
        if self.sentinel_window <= 0:
            raise ValueError(
                f"serve_sentinel_window = {self.sentinel_window}: must "
                "be > 0 (seconds per observation window)")
        self.shapes = tuple(self.shapes)
        if not (self.shapes and all(s > 0 for s in self.shapes)
                and list(self.shapes) == sorted(set(self.shapes))):
            raise ValueError(f"serve_shapes must be positive ascending, got "
                             f"{self.shapes}")
        if self.dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"serve_dtype = {self.dtype!r}: expected f32, "
                             "bf16, or int8")
        if self.max_batch <= 0:
            self.max_batch = max(self.shapes)
        if self.gen_sample not in ("greedy", "temperature", "topk"):
            raise ValueError(f"serve_gen_sample = {self.gen_sample!r}: "
                             "expected greedy, temperature, or topk")
        if self.gen_batching not in ("continuous", "request"):
            raise ValueError(f"serve_gen_batching = {self.gen_batching!r}: "
                             "expected continuous or request")
        if self.gen_sample == "topk" and self.gen_topk < 1:
            raise ValueError(
                "serve_gen_sample = topk requires serve_gen_topk >= 1")
        if self.gen_prompt_doc not in (0, 1):
            raise ValueError(f"serve_gen_prompt_doc = {self.gen_prompt_doc}: "
                             "expected 0 or 1")
        if self.spec_k < 0:
            raise ValueError(f"spec_k = {self.spec_k}: must be >= 0")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"decode_prefill_chunk = {self.prefill_chunk}: must be >= 0 "
                "(0 = whole-prompt prefill)")
        if self.kv_dtype not in ("", "f32", "bf16"):
            raise ValueError(f"decode_kv_dtype = {self.kv_dtype!r}: "
                             "expected f32 or bf16")
        if not 0 <= self.admin_port <= 65535:
            raise ValueError(
                f"serve_admin_port = {self.admin_port}: expected "
                "0 (off) or a port in 1..65535")
        if self.slo_p99_ms > 0.0 and not 0.0 < self.slo_avail < 1.0:
            raise ValueError(
                f"serve_slo_avail = {self.slo_avail}: must be in "
                "(0, 1) when serve_slo_p99_ms is set (1.0 leaves a "
                "zero error budget)")
        if self.slo_fast_sec <= 0 or self.slo_slow_sec <= 0:
            raise ValueError("serve_slo_*_sec windows must be > 0")

    @classmethod
    def from_pairs(cls, pairs: Sequence[Tuple[str, str]]) -> "ServeConfig":
        """Build from ordered config pairs (last occurrence wins)."""
        last = dict(pairs)
        kw = {}
        if "serve_shapes" in last:
            kw["shapes"] = tuple(parse_shapes(last["serve_shapes"]))
        for key, field, conv in (
                ("serve_max_batch", "max_batch", int),
                ("serve_max_wait_ms", "max_wait_ms", float),
                ("serve_dtype", "dtype", str),
                ("serve_clients", "clients", int),
                ("serve_calib", "calib", int),
                ("serve_queue_depth", "queue_depth", int),
                ("serve_gen", "gen", int),
                ("decode_slots", "slots", int),
                ("decode_max_seqlen", "max_seqlen", int),
                ("serve_gen_tokens", "gen_tokens", int),
                ("serve_gen_sample", "gen_sample", str),
                ("serve_gen_temp", "gen_temp", float),
                ("serve_gen_topk", "gen_topk", int),
                ("serve_gen_seed", "gen_seed", int),
                ("serve_gen_eos", "gen_eos", int),
                ("serve_gen_prompt", "gen_prompt", int),
                ("serve_gen_prompt_doc", "gen_prompt_doc", int),
                ("serve_gen_batching", "gen_batching", str),
                ("serve_draft_model", "draft_model", str),
                ("spec_k", "spec_k", int),
                ("decode_prefill_chunk", "prefill_chunk", int),
                ("decode_kv_dtype", "kv_dtype", str),
                ("serve_sentinel", "sentinel", int),
                ("serve_sentinel_window", "sentinel_window", float),
                ("serve_admin_port", "admin_port", int),
                ("serve_slo_p99_ms", "slo_p99_ms", float),
                ("serve_slo_avail", "slo_avail", float),
                ("serve_slo_fast_sec", "slo_fast_sec", float),
                ("serve_slo_slow_sec", "slo_slow_sec", float),
                ("serve_slo_fast_burn", "slo_fast_burn", float),
                ("serve_slo_slow_burn", "slo_slow_burn", float),
                ("serve_flight_requests", "flight_requests", int),
                ("serve_flight_boost", "flight_boost", int)):
            if key in last:
                kw[field] = conv(last[key])
        return cls(**kw)

"""Serving: ``task = serve`` with ``serve_gen = 1`` — KV-cached
incremental decode (:mod:`.decode`) behind the token-level
continuous-batching step scheduler (:mod:`.batcher`), hosted by
:class:`~cxxnet_tpu_torch.serve.host.GenModel`.

:class:`ServeConfig` parses the same ``serve_*`` / ``decode_*`` keys as
the JAX package, plus one of the port's own: ``serve_gen_prompt_doc =
1`` makes every document of a ``packseq`` prompt row its own request
(its first ``serve_gen_prompt`` ids), so prompts keep their own lengths;
the default ``0`` takes each row's leading ``serve_gen_prompt`` ids, as
the JAX package does.  Keys of pieces not ported yet (speculative decoding,
chunked prefill, a KV-cache dtype other than the net's, the admin
plane) are parsed and rejected when set, rather than ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass
class ServeConfig:
    clients: int = 4
    queue_depth: int = 64
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
    # not ported yet: rejected when set
    draft_model: str = ""
    spec_k: int = 0
    prefill_chunk: int = 0
    kv_dtype: str = ""
    admin_port: int = 0

    def __post_init__(self):
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
        if self.kv_dtype not in ("", "f32", "bf16"):
            raise ValueError(f"decode_kv_dtype = {self.kv_dtype!r}: "
                             "expected f32 or bf16")
        for key, val, off in (("serve_draft_model", self.draft_model, ""),
                              ("spec_k", self.spec_k, 0),
                              ("decode_prefill_chunk", self.prefill_chunk, 0),
                              ("serve_admin_port", self.admin_port, 0)):
            if val != off:
                raise ValueError(f"{key} = {val}: not ported to "
                                 "cxxnet_tpu_torch yet (ROADMAP.md)")

    @classmethod
    def from_pairs(cls, pairs: Sequence[Tuple[str, str]]) -> "ServeConfig":
        """Build from ordered config pairs (last occurrence wins)."""
        last = dict(pairs)
        kw = {}
        for key, field, conv in (
                ("serve_clients", "clients", int),
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
                ("serve_admin_port", "admin_port", int)):
            if key in last:
                kw[field] = conv(last[key])
        return cls(**kw)

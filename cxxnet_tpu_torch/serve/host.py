"""Model hosting for generation: :class:`GenModel` bundles a KV-cache
decode engine with its step scheduler (the JAX package's
``serve/host.py`` ``GenModel``, without a draft model or block
widths)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import ServeConfig
from .batcher import StepScheduler
from .decode import DecodeEngine


class GenModel:
    """One served LM: ``warmup`` once, then ``generate`` from any number
    of client threads; ``close`` drains and joins the scheduler."""

    def __init__(self, trainer, cfg: Optional[ServeConfig] = None, *,
                 metrics=None, name: str = "default"):
        self.name = name
        self.cfg = cfg or ServeConfig(gen=1)
        self.trainer = trainer
        self.metrics = metrics if metrics is not None else trainer.metrics
        self.engine = DecodeEngine(trainer, slots=self.cfg.slots,
                                   max_seqlen=self.cfg.max_seqlen,
                                   metrics=self.metrics,
                                   kv_dtype=self.cfg.kv_dtype)
        self.scheduler = StepScheduler(
            self.engine, max_new_tokens=self.cfg.gen_tokens,
            eos=self.cfg.gen_eos, sample=self.cfg.gen_sample,
            temp=self.cfg.gen_temp, topk=self.cfg.gen_topk,
            seed=self.cfg.gen_seed, queue_depth=self.cfg.queue_depth,
            continuous=self.cfg.gen_batching == "continuous",
            metrics=self.metrics, name=name)

    def warmup(self) -> None:
        self.engine.warmup()
        self.scheduler.start()

    def generate(self, prompt: np.ndarray,
                 max_new_tokens: Optional[int] = None) -> list:
        """Generated token ids for ``prompt``.  Thread-safe."""
        return self.scheduler.submit(prompt, max_new_tokens)

    def footprint(self) -> Dict[str, int]:
        return self.engine.footprint()

    def close(self) -> None:
        self.scheduler.close()

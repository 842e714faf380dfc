"""Model hosting: engine + front-end bundles, routed by model name (the
JAX package's ``serve/host.py``).

* :class:`ServeModel` — a pinned-shape :class:`PredictEngine` behind its
  own :class:`MicroBatcher`;
* :class:`GenModel` — a KV-cache :class:`DecodeEngine` (and, for
  speculative decoding, a draft net's engine) behind the
  :class:`StepScheduler`;
* :class:`ModelHost` — the routing table over the process's device, the
  ready lifecycle (ready only once every hosted model has warmed with
  zero retraces, and not ready from the first line of ``close``) and the
  admin endpoint (:meth:`ModelHost.start_admin`, serve/admin.py), which
  ``close`` joins last, so ``/healthz`` answers through the drain.

:func:`load_serve_model` and :func:`load_draft_trainer` build a model's
trainer from config pairs and a snapshot.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import ServeConfig
from ..monitor import log as mlog
from .batcher import MicroBatcher, StepScheduler
from .decode import DecodeEngine
from .engine import PredictEngine


class ServeModel:
    """One served model: a pinned-shape engine fronted by its own
    micro-batcher.  ``predict`` is the thread-safe client surface."""

    def __init__(self, trainer, cfg: Optional[ServeConfig] = None, *,
                 metrics=None, name: str = "default",
                 engine: Optional[PredictEngine] = None):
        self.name = name
        self.cfg = cfg or ServeConfig()
        self.trainer = trainer
        self.metrics = metrics if metrics is not None else trainer.metrics
        self.engine = engine if engine is not None else PredictEngine(
            trainer, shapes=self.cfg.shapes, dtype=self.cfg.dtype,
            metrics=self.metrics)
        max_batch = min(self.cfg.max_batch, max(self.cfg.shapes))
        if self.cfg.max_batch > max(self.cfg.shapes):
            mlog.warn(f"serve[{name}]: serve_max_batch = "
                      f"{self.cfg.max_batch} exceeds the largest bucket "
                      f"({max(self.cfg.shapes)}); coalescing caps at the "
                      "bucket")
        self.batcher = MicroBatcher(
            self.engine.predict, max_batch=max_batch,
            max_wait_ms=self.cfg.max_wait_ms,
            queue_depth=self.cfg.queue_depth, metrics=self.metrics,
            name=name)

    def warmup(self) -> None:
        """Run every bucket once (a ``serve_warmup`` span under
        ``trace_sample``) and start the dispatcher."""
        with self.metrics.tracer.span("serve_warmup", model=self.name,
                                      buckets=len(self.engine.shapes)):
            self.engine.warmup()
        self.batcher.start()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Final-node rows for ``x``, batched with whatever other
        requests are in flight.  Thread-safe."""
        return self.batcher.submit(np.asarray(x, np.float32))

    @property
    def warmed(self) -> bool:
        return self.engine.warmed

    @property
    def retraces(self) -> int:
        return self.engine.retraces

    def footprint(self) -> Dict[str, int]:
        return self.engine.footprint()

    def close(self) -> None:
        self.batcher.close()


class GenModel:
    """One served LM: ``warmup`` once, then ``generate`` from any number
    of client threads; ``close`` drains and joins the scheduler.  With
    ``draft_trainer`` and ``spec_k >= 1`` it decodes speculatively."""

    def __init__(self, trainer, cfg: Optional[ServeConfig] = None, *,
                 draft_trainer=None, metrics=None, name: str = "default"):
        self.name = name
        self.cfg = cfg or ServeConfig(gen=1)
        self.trainer = trainer
        self.metrics = metrics if metrics is not None else trainer.metrics
        spec = draft_trainer is not None and self.cfg.spec_k >= 1
        # the block widths warmup runs: the verify (spec_k + 1) and the
        # chunked-prefill tick
        widths = []
        if spec:
            widths.append(self.cfg.spec_k + 1)
        if self.cfg.prefill_chunk > 0:
            widths.append(self.cfg.prefill_chunk)
        self.engine = DecodeEngine(trainer, slots=self.cfg.slots,
                                   max_seqlen=self.cfg.max_seqlen,
                                   metrics=self.metrics,
                                   kv_dtype=self.cfg.kv_dtype,
                                   block_widths=widths)
        self.draft = None
        if spec:
            # the draft shares the slots and the cache length, so slot
            # ids line up across the two engines
            self.draft = DecodeEngine(
                draft_trainer, slots=self.cfg.slots,
                max_seqlen=self.engine.max_seqlen, metrics=self.metrics,
                kv_dtype=self.cfg.kv_dtype)
            if self.draft.vocab != self.engine.vocab:
                raise ValueError(
                    f"serve_draft_model: draft vocab {self.draft.vocab} != "
                    f"flagship vocab {self.engine.vocab}")
            if self.draft.max_seqlen != self.engine.max_seqlen:
                raise ValueError(
                    f"serve_draft_model: draft max_seqlen "
                    f"{self.draft.max_seqlen} != flagship "
                    f"{self.engine.max_seqlen} (the draft net must be built "
                    "at the flagship's decode width)")
        self.scheduler = StepScheduler(
            self.engine, max_new_tokens=self.cfg.gen_tokens,
            eos=self.cfg.gen_eos, sample=self.cfg.gen_sample,
            temp=self.cfg.gen_temp, topk=self.cfg.gen_topk,
            seed=self.cfg.gen_seed, queue_depth=self.cfg.queue_depth,
            continuous=self.cfg.gen_batching == "continuous",
            draft=self.draft, spec_k=self.cfg.spec_k,
            prefill_chunk=self.cfg.prefill_chunk, metrics=self.metrics,
            name=name)

    def warmup(self) -> None:
        """Warm the flagship (prefill, step, each block width) and the
        draft (prefill, step), a ``decode_warmup`` span under
        ``trace_sample``, then start the scheduler."""
        with self.metrics.tracer.span("decode_warmup", model=self.name,
                                      slots=self.engine.slots):
            self.engine.warmup()
            if self.draft is not None:
                self.draft.warmup()
        self.scheduler.start()

    def generate(self, prompt: np.ndarray,
                 max_new_tokens: Optional[int] = None) -> list:
        """Generated token ids for ``prompt``.  Thread-safe."""
        return self.scheduler.submit(prompt, max_new_tokens)

    @property
    def warmed(self) -> bool:
        return self.engine.warmed and (self.draft is None
                                       or self.draft.warmed)

    @property
    def retraces(self) -> int:
        n = self.engine.retraces
        if self.draft is not None:
            n += self.draft.retraces
        return n

    def footprint(self) -> Dict[str, int]:
        fp = self.engine.footprint()
        if self.draft is not None:
            fp["draft_bytes"] = self.draft.footprint()["total_bytes"]
            fp["total_bytes"] += fp["draft_bytes"]
        return fp

    def close(self) -> None:
        self.scheduler.close()


class ModelHost:
    """Concurrent multi-model routing over the shared device, with the
    ready lifecycle: ``ready`` is False until :meth:`mark_ready` finds
    every hosted model warmed with zero retraces, and False again from
    the first line of :meth:`close`, before any front end drains."""

    def __init__(self):
        self._models: Dict[str, object] = {}
        self._ready = False
        self.admin = None       # AdminServer once start_admin ran

    @property
    def ready(self) -> bool:
        return self._ready

    def mark_ready(self) -> bool:
        """Flip ready if (and only if) at least one model is hosted,
        every one has warmed, and none has retraced.  Returns the new
        state."""
        warmed = bool(self._models) and all(
            m.warmed for m in self._models.values())
        self._ready = warmed and self.retraces() == 0
        if self._ready and self.admin is not None:
            self.admin.note_ready()     # footprints cached for /statusz
        elif warmed and not self._ready:
            mlog.warn(f"host not ready: {self.retraces()} retraces after "
                      "warmup")
        return self._ready

    def start_admin(self, metrics, *, port: int, config=None):
        """Start the admin endpoint on ``port`` (0 binds an ephemeral
        one); the host owns it."""
        from .admin import AdminServer
        if self.admin is not None:
            raise RuntimeError("admin endpoint already started")
        self.admin = AdminServer(self, metrics, port=port, config=config)
        self.admin.start()
        return self.admin

    def add(self, name: str, trainer, cfg: Optional[ServeConfig] = None, *,
            metrics=None, warmup: bool = True) -> ServeModel:
        if name in self._models:
            raise ValueError(f"model {name!r} already hosted")
        return self.attach(ServeModel(trainer, cfg, metrics=metrics,
                                      name=name), warmup=warmup)

    def attach(self, sm, *, warmup: bool = True):
        """Host an already-built :class:`ServeModel` or :class:`GenModel`
        under its own name."""
        if sm.name in self._models:
            raise ValueError(f"model {sm.name!r} already hosted")
        self._models[sm.name] = sm
        if warmup:
            sm.warmup()
        return sm

    def model(self, name: str):
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(f"no model {name!r} hosted; available: "
                           f"{sorted(self._models)}") from None

    def predict(self, name: str, x: np.ndarray) -> np.ndarray:
        return self.model(name).predict(x)

    @property
    def names(self):
        return sorted(self._models)

    def retraces(self) -> int:
        return sum(m.retraces for m in self._models.values())

    def footprint(self) -> Dict[str, object]:
        """Per-model and combined resident bytes."""
        per = {name: m.footprint() for name, m in self._models.items()}
        return {"models": per,
                "total_bytes": sum(fp.get("total_bytes", 0)
                                   for fp in per.values())}

    def close(self) -> None:
        self._ready = False     # /readyz flips before any drain begins
        for m in self._models.values():
            m.close()
        self._models.clear()
        if self.admin is not None:
            self.admin.close()
            self.admin = None


def _trainer(pairs: Sequence[Tuple[str, str]], path: str):
    from ..nnet.trainer import NetTrainer
    t = NetTrainer()
    for k, v in pairs:
        t.set_param(k, v)
    t.load_model(path)
    return t


def load_serve_model(pairs: Sequence[Tuple[str, str]], *,
                     name: str = "default", warmup: bool = True
                     ) -> ServeModel:
    """A :class:`ServeModel` from ordered config pairs: ``model_in``
    names the snapshot (the net comes from it), ``batch_size`` / ``dev``
    / ``dtype`` / engine keys configure the trainer, ``serve_*`` keys the
    front end."""
    model_in = dict(pairs).get("model_in", "NULL")
    if model_in == "NULL":
        raise ValueError("serve: model_in (a snapshot) is required")
    sm = ServeModel(_trainer(pairs, model_in), ServeConfig.from_pairs(pairs),
                    name=name)
    if warmup:
        sm.warmup()
    return sm


def load_draft_trainer(pairs: Sequence[Tuple[str, str]], path: str):
    """The speculative DRAFT net's trainer from its own snapshot
    (``serve_draft_model``): the session pairs configure the trainer,
    the snapshot's header the draft's own net, so the flagship's
    ``netconfig`` never leaks into the draft."""
    return _trainer(pairs, path)

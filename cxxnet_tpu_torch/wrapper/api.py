"""numpy-facing Python API: Net / DataIter / ServingHost / train.

The JAX package's ``wrapper/api.py`` over the port.  Reference:
``wrapper/cxxnet.py`` (Python-2 ctypes wrapper over the C ABI,
``wrapper/cxxnet_wrapper.h``).  Same surface, modern Python: a ``Net`` is
configured by a config string + set_param calls, updates on numpy batches or
a DataIter, and exposes predict/extract/evaluate/get_weight/set_weight.  The
C ABI over this module is ``cxxnet_tpu_torch/native/capi.cc`` (built by
``cxxnet_tpu_torch/native/build.py``) for C/C++ embedders; Python users get
this module directly.  ``dev`` defaults to the card (``gpu``); pass
``dev = "cpu"`` to run on the CPU.

Several device ids (``gpu:0-1``, ``cpu:0-3``) are a mesh of one process
a device, as the CLI runs them: a ``Net`` takes them inside a joined
process group of that many ranks (``parallel.mesh.spawn``, or
``init_distributed`` in each process), every rank makes the same calls,
``update`` trains on each rank's rows of the batch and ``predict`` /
``extract`` return every row on every rank (:meth:`Net.enable_serving`
says how serving runs there).  Outside a
group the trainer refuses them when the net is built (``init_model`` /
``load_model``) and names ``parallel.mesh.spawn``: where the JAX
package drives several devices from one process, the port runs one
process a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.data import DataBatch
from ..io.factory import create_iterator, init_iterator
from ..monitor import log as mlog
from ..nnet.trainer import NetTrainer
from ..utils.config import parse_config_string


class DataIter:
    """Iterator built from a config string (CXNIOCreateFromConfig parity:
    the same ``iter = ...`` sections the CLI uses)."""

    def __init__(self, cfg: str):
        pairs = parse_config_string(cfg)
        self._it = create_iterator(pairs)
        init_iterator(self._it, [])
        self.head = True
        self.tail = False
        self._batch: Optional[DataBatch] = None

    def before_first(self) -> None:
        self._it.before_first()
        self.head = True
        self.tail = False

    def next(self) -> bool:
        self._batch = self._it.next()
        self.head = False
        self.tail = self._batch is None
        return not self.tail

    def check_valid(self) -> None:
        if self.head:
            raise RuntimeError(
                "iterator at head state, call next() to get to a valid state")
        if self.tail:
            raise RuntimeError("iterator reached the end")

    @property
    def value(self) -> DataBatch:
        self.check_valid()
        return self._batch

    def get_data(self) -> np.ndarray:
        self.check_valid()
        return self._batch.data

    def get_label(self) -> np.ndarray:
        self.check_valid()
        return self._batch.label


def _as_batch(data: np.ndarray, label: Optional[np.ndarray]) -> DataBatch:
    if data.ndim != 4:
        raise ValueError(
            "need a 4-d tensor (batch, channel, height, width)")
    if label is None:
        label = np.zeros((data.shape[0], 1), np.float32)
    else:
        label = np.array(label, np.float32)
        if label.ndim == 1:
            label = label.reshape(-1, 1)
        if label.ndim != 2 or label.shape[0] != data.shape[0]:
            raise ValueError("label must be (batch,) or (batch, width)")
    # a copy: the C ABI hands in read-only views of the caller's memory
    return DataBatch(data=np.array(data, np.float32), label=label,
                     index=np.arange(data.shape[0], dtype=np.uint32))


class Net:
    """Neural net object (CXNNetCreate parity)."""

    def __init__(self, dev: str = "gpu", cfg: str = ""):
        self._trainer = NetTrainer()
        self._trainer.set_param("dev", dev)
        for k, v in parse_config_string(cfg):
            self._trainer.set_param(k, v)
        self._serve = None

    def set_param(self, name, value) -> None:
        self._trainer.set_param(str(name), str(value))

    def init_model(self) -> None:
        self._trainer.init_model()

    def load_model(self, fname: str) -> None:
        self._trainer.load_model(fname)

    def save_model(self, fname: str) -> None:
        self._trainer.save_model(fname)

    def copy_model_from(self, fname: str) -> None:
        self._trainer.copy_model_from(fname)

    def start_round(self, round_counter: int) -> None:
        self._trainer.start_round(round_counter)

    def update(self, data, label: Optional[np.ndarray] = None) -> None:
        """Update on a DataIter's current batch or a numpy (data, label)."""
        if isinstance(data, DataIter):
            data.check_valid()
            self._trainer.update(data.value)
        elif isinstance(data, np.ndarray):
            if label is None:
                raise ValueError("Net.update: need label to update")
            self._trainer.update(_as_batch(data, label))
        else:
            raise TypeError(f"update does not support {type(data)}")

    def enable_serving(self, cfg: str = "") -> None:
        """Route ``predict`` through the dynamic micro-batching serve
        path (serve/, doc/serve.md): pinned shape buckets compile once
        here, then concurrent ``predict`` calls from ANY thread coalesce
        into batched dispatches and never retrace.  ``cfg`` takes the
        same ``serve_* = value`` pairs the CLI task does
        (``"serve_shapes = 1,8\\nserve_dtype = bf16"``).  The legacy
        single-shot path returns on :meth:`disable_serving` — and stays
        in use for ``DataIter`` inputs either way (their batches carry
        padding metadata the serve path deliberately doesn't).  On a
        mesh every rank calls it: rank 0 serves, and each other rank
        runs rank 0's dispatches until rank 0's :meth:`disable_serving`
        (rank 0 makes no other call that computes until then)."""
        from ..serve import ServeConfig
        from ..serve.engine import PredictEngine
        from ..serve.host import ServeModel
        if self._serve is not None:
            raise RuntimeError("serving already enabled")
        scfg = ServeConfig.from_pairs(parse_config_string(cfg))
        engine = PredictEngine(self._trainer, shapes=scfg.shapes,
                               dtype=scfg.dtype)
        mesh = engine.mesh
        if mesh is not None and mesh.rank != 0:
            # on a mesh rank 0 serves; this rank runs each of its
            # dispatches and returns at its disable_serving
            engine.follow()
            return
        try:
            sm = ServeModel(self._trainer, scfg, engine=engine)
            try:
                sm.warmup()
            except BaseException:
                sm.close()
                raise
        except BaseException:
            engine.stop()
            raise
        self._serve = sm

    def disable_serving(self) -> None:
        """Shut the batcher down (joins its thread) and restore the
        legacy single-shot predict; on rank 0 of a mesh the other ranks'
        :meth:`enable_serving` returns here."""
        if self._serve is not None:
            self._serve.close()
            self._serve.engine.stop()
            self._serve = None

    def predict(self, data) -> np.ndarray:
        if isinstance(data, DataIter):
            data.check_valid()
            return self._trainer.predict(data.value)
        if self._serve is not None:
            raw = self._serve.predict(
                _as_batch(np.asarray(data), None).data)
            if raw.shape[1] > 1:
                return raw.argmax(axis=1).astype(np.float32)
            return raw[:, 0]
        return self._trainer.predict(_as_batch(np.asarray(data), None))

    def extract(self, data, node_name: str) -> np.ndarray:
        if isinstance(data, DataIter):
            data.check_valid()
            return self._trainer.extract_feature(data.value, node_name)
        return self._trainer.extract_feature(
            _as_batch(np.asarray(data), None), node_name)

    def evaluate(self, data: "DataIter", name: str) -> str:
        if not isinstance(data, DataIter):
            raise TypeError(
                f"evaluate needs a DataIter, got {type(data).__name__}")
        return self._trainer.evaluate(iter(data._it), name)

    def get_weight(self, layer_name: str, tag: str) -> Optional[np.ndarray]:
        if tag not in ("wmat", "bias"):
            raise ValueError("tag must be bias or wmat")
        try:
            return self._trainer.get_weight(layer_name, tag)
        except KeyError:
            return None

    def set_weight(self, weight: np.ndarray, layer_name: str, tag: str) -> None:
        if tag not in ("wmat", "bias"):
            raise ValueError("tag must be bias or wmat")
        self._trainer.set_weight(np.asarray(weight, np.float32),
                                 layer_name, tag)


class ServingHost:
    """Concurrent multi-model serving from Python (serve/host.py over
    config strings): load N snapshots, route by model name, share the
    process's device pool.  Each model gets its own micro-batcher and
    shape buckets, so ``predict`` is thread-safe per model AND across
    models.

        host = ServingHost()
        host.add_model("mnist", "model_in = m/0010.model\\n"
                                "batch_size = 100\\nserve_shapes = 1,8")
        host.predict("mnist", rows)   # from any thread
        host.close()
    """

    def __init__(self, dev: str = "gpu"):
        from ..serve.host import ModelHost
        self._dev = dev
        self._host = ModelHost()

    def add_model(self, name: str, cfg: str) -> None:
        """Load one snapshot behind its own engine+batcher.  ``cfg`` is
        the usual config-string surface and must carry ``model_in``
        (the snapshot) and ``batch_size``; ``serve_*`` keys configure
        this model's buckets/dtype/batching."""
        from ..serve.host import load_serve_model
        pairs = [("dev", self._dev)] + parse_config_string(cfg)
        self._host.attach(load_serve_model(pairs, name=name, warmup=False))

    @property
    def models(self):
        return self._host.names

    def predict(self, name: str, data: np.ndarray) -> np.ndarray:
        """Raw output rows of model ``name`` for ``(n, c, h, w)`` data."""
        return self._host.predict(name,
                                  _as_batch(np.asarray(data), None).data)

    def retraces(self) -> int:
        """Total traces past warmup across hosted models (0 = healthy)."""
        return self._host.retraces()

    def close(self) -> None:
        self._host.close()


def train(cfg: str, data, num_round: int, param, eval_data=None,
          label: Optional[np.ndarray] = None, dev: str = "gpu") -> Net:
    """One-call train loop (wrapper/cxxnet.py train parity).

    ``data`` is a DataIter, or a numpy array with ``label=``.
    """
    net = Net(dev=dev, cfg=cfg)
    items = param.items() if isinstance(param, dict) else param
    for k, v in items:
        net.set_param(k, v)
    net.init_model()
    for r in range(num_round):
        net.start_round(r)
        if isinstance(data, DataIter):
            data.before_first()
            scounter = 0
            while data.next():
                net.update(data)
                scounter += 1
                if scounter % 100 == 0:
                    mlog.notice(f"[{r}] {scounter} batch passed")
        else:
            net.update(data=data, label=label)
        if eval_data is not None:
            mlog.result(net.evaluate(eval_data, "eval"))
    return net

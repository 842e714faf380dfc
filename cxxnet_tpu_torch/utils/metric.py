"""Evaluation metrics: rmse / error / logloss / rec@n and the MetricSet
(the JAX package's ``utils/metric.py``; reference
``src/utils/metric.h:20-236``).

Metrics run on the host over numpy copies of the eval nodes' outputs,
padding instances excluded by the caller.  A metric line is made of
``\\t<eval name>-<metric>:<value>`` fragments, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class Metric:
    name = ""

    def __init__(self):
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def clear(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def add_eval(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred (n, k) scores, label (n, label_width)."""
        vals = self._calc(pred.astype(np.float64), label.astype(np.float64))
        self.sum_metric += float(vals.sum())
        self.cnt_inst += pred.shape[0]

    def get(self) -> float:
        return self.sum_metric / max(self.cnt_inst, 1)

    def _calc(self, pred: np.ndarray, label: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class MetricRMSE(Metric):
    name = "rmse"

    def _calc(self, pred, label):
        assert pred.shape[1] == label.shape[1], \
            "rmse: prediction and label sizes must match"
        return np.square(pred - label).sum(axis=1)


class MetricError(Metric):
    """argmax error of multi-class scores; a single column is thresholded
    at 0 (metric.h MetricError)."""

    name = "error"

    def _calc(self, pred, label):
        if pred.shape[1] != 1:
            maxidx = pred.argmax(axis=1)
        else:
            maxidx = (pred[:, 0] > 0.0).astype(np.int64)
        return (maxidx != label[:, 0].astype(np.int64)).astype(np.float64)


class MetricLogloss(Metric):
    name = "logloss"

    def _calc(self, pred, label):
        eps = 1e-15
        if pred.shape[1] != 1:
            tgt = label[:, 0].astype(np.int64)
            p = np.clip(pred[np.arange(len(tgt)), tgt], eps, 1 - eps)
            return -np.log(p)
        p = np.clip(pred[:, 0], eps, 1 - eps)
        y = label[:, 0]
        res = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        assert not np.isnan(res).any(), "NaN detected!"
        return res


class MetricRecall(Metric):
    """rec@n: the share of an instance's labels among its top n scores,
    ties ordered at random (metric.h MetricRecall)."""

    def __init__(self, name: str):
        super().__init__()
        assert name.startswith("rec@"), "must specify n for rec@n"
        self.name = name
        self.topn = int(name[4:])
        self._rng = np.random.RandomState(0)

    def _calc(self, pred, label):
        n, k = pred.shape
        assert k >= self.topn, \
            f"rec@{self.topn} meaningless for score list of length {k}"
        # one random secondary key per score: equal scores are ordered
        # uniformly at random, the reference's shuffle-then-stable-sort
        tiebreak = self._rng.random_sample((n, k))
        top = np.lexsort((tiebreak, -pred), axis=1)[:, :self.topn]
        lab = label.astype(np.int64)
        hits = (top[:, :, None] == lab[:, None, :]).any(axis=2).sum(axis=1)
        return hits / label.shape[1]


def create_metric(name: str) -> Metric:
    if name == "rmse":
        return MetricRMSE()
    if name == "error":
        return MetricError()
    if name == "logloss":
        return MetricLogloss()
    if name.startswith("rec@"):
        return MetricRecall(name)
    raise ValueError(f"unknown metric {name!r}")


class MetricSet:
    """(metric, label field) bindings (metric.h MetricSet)."""

    def __init__(self):
        self.evals: List[Metric] = []
        self.label_fields: List[str] = []

    def add_metric(self, name: str, label_field: str) -> None:
        for m, f in zip(self.evals, self.label_fields):
            if m.name == name and f == label_field:
                return
        self.evals.append(create_metric(name))
        self.label_fields.append(label_field)

    def clear(self) -> None:
        for m in self.evals:
            m.clear()

    def add_eval(self, predscores: List[np.ndarray],
                 labels: Dict[str, np.ndarray]) -> None:
        """predscores[i] pairs with self.evals[i]."""
        for m, f, p in zip(self.evals, self.label_fields, predscores):
            m.add_eval(p, labels[f])

    def print_line(self, evname: str) -> str:
        return "".join(f"\t{evname}-{m.name}:{m.get():f}" for m in self.evals)

    def values(self, evname: str) -> Dict[str, float]:
        """``{"<evname>-<metric>": value}``, the keys spelled as in the
        printed line."""
        return {f"{evname}-{m.name}": m.get() for m in self.evals}

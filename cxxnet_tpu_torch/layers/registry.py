"""Layer factory: config type name -> layer instance (the JAX package's
``layers/registry.py``, over the layers ported so far).  A layer of the
JAX package that is not ported yet raises "not ported" by name."""

from __future__ import annotations

from typing import Dict, Type

from .activation import (GeluLayer, ReluLayer, SigmoidLayer, SoftplusLayer,
                         TanhLayer)
from .base import Layer
from .conv import (AvgPoolingLayer, ConvolutionLayer, LRNLayer,
                   MaxPoolingLayer, ReluMaxPoolingLayer, SumPoolingLayer)
from .fullc import FullConnectLayer
from .loss import L2LossLayer, MultiLogisticLayer, SoftmaxLayer
from .norm import DropoutLayer
from .sequence import (AttentionLayer, EmbeddingLayer, LayerNormLayer,
                       SeqFullcLayer, SoftmaxSeqLayer)
from .shape_ops import EltSumLayer, FlattenLayer, SplitLayer

_REGISTRY: Dict[str, Type[Layer]] = {}


def register(cls: Type[Layer]) -> None:
    for name in cls.type_names:
        _REGISTRY[name] = cls


for _cls in (SplitLayer, EltSumLayer, FlattenLayer, GeluLayer, ReluLayer,
             SigmoidLayer, TanhLayer, SoftplusLayer, ConvolutionLayer,
             MaxPoolingLayer, ReluMaxPoolingLayer, SumPoolingLayer,
             AvgPoolingLayer, LRNLayer, FullConnectLayer, DropoutLayer,
             SoftmaxLayer, L2LossLayer, MultiLogisticLayer, EmbeddingLayer,
             LayerNormLayer, SeqFullcLayer, AttentionLayer, SoftmaxSeqLayer):
    register(_cls)

#: layers of the JAX package that the port does not implement yet
NOT_PORTED = ("xelu", "insanity", "prelu", "bias", "fixconn",
              "insanity_max_pooling", "batch_norm", "concat", "ch_concat",
              "maxout", "moe", "pairtest", "torch")


def layer_type_names():
    return sorted(_REGISTRY)


def create_layer(type_name: str) -> Layer:
    """Create a layer from its config type name."""
    if type_name.startswith("share"):
        raise ValueError("shared layers are resolved by the net graph")
    if type_name in NOT_PORTED or type_name.startswith("pairtest"):
        raise ValueError(f"layer type {type_name!r} is not ported to "
                         "cxxnet_tpu_torch yet (ROADMAP.md)")
    if type_name not in _REGISTRY:
        raise ValueError(f"unknown layer type: {type_name!r} (not ported to "
                         f"cxxnet_tpu_torch yet?); known: "
                         f"{layer_type_names()}")
    return _REGISTRY[type_name]()

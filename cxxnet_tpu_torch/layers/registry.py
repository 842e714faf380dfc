"""Layer factory: config type name -> layer instance (the JAX package's
``layers/registry.py``, over the layers ported so far)."""

from __future__ import annotations

from typing import Dict, Type

from .activation import GeluLayer
from .base import Layer
from .sequence import (AttentionLayer, EmbeddingLayer, LayerNormLayer,
                       SeqFullcLayer, SoftmaxSeqLayer)
from .shape_ops import EltSumLayer, SplitLayer

_REGISTRY: Dict[str, Type[Layer]] = {}


def register(cls: Type[Layer]) -> None:
    for name in cls.type_names:
        _REGISTRY[name] = cls


for _cls in (SplitLayer, EltSumLayer, GeluLayer, EmbeddingLayer,
             LayerNormLayer, SeqFullcLayer, AttentionLayer, SoftmaxSeqLayer):
    register(_cls)


def layer_type_names():
    return sorted(_REGISTRY)


def create_layer(type_name: str) -> Layer:
    """Create a layer from its config type name."""
    if type_name.startswith("share"):
        raise ValueError("shared layers are resolved by the net graph")
    if type_name not in _REGISTRY:
        raise ValueError(f"unknown layer type: {type_name!r} (not ported to "
                         f"cxxnet_tpu_torch yet?); known: "
                         f"{layer_type_names()}")
    return _REGISTRY[type_name]()

"""Layer factory: config type name -> layer instance (the JAX package's
``layers/registry.py``).  ``pairtest-<master>-<slave>`` composes
recursively (the reference encodes it as kPairTestGap*master+slave); the
``torch`` plugin layer is registered beside the native types.  A layer
of the JAX package that is not ported yet raises "not ported" by
name."""

from __future__ import annotations

from typing import Dict, Type

from .activation import (BiasLayer, GeluLayer, InsanityLayer, PReluLayer,
                         ReluLayer, SigmoidLayer, SoftplusLayer, TanhLayer,
                         XeluLayer)
from .base import Layer
from .conv import (AvgPoolingLayer, ConvolutionLayer, InsanityPoolingLayer,
                   LRNLayer, MaxPoolingLayer, ReluMaxPoolingLayer,
                   SumPoolingLayer)
from .fullc import FixConnectLayer, FullConnectLayer
from .loss import L2LossLayer, MultiLogisticLayer, SoftmaxLayer
from .moe import MoELayer
from .norm import BatchNormLayer, DropoutLayer
from .pairtest import PairTestLayer
from .sequence import (AttentionLayer, EmbeddingLayer, LayerNormLayer,
                       SeqFullcLayer, SoftmaxSeqLayer)
from .shape_ops import (ChConcatLayer, ConcatLayer, EltSumLayer,
                        FlattenLayer, MaxoutLayer, SplitLayer)

_REGISTRY: Dict[str, Type[Layer]] = {}


def register(cls: Type[Layer]) -> None:
    for name in cls.type_names:
        _REGISTRY[name] = cls


for _cls in (SplitLayer, EltSumLayer, FlattenLayer, ConcatLayer,
             ChConcatLayer, MaxoutLayer, GeluLayer, ReluLayer, SigmoidLayer,
             TanhLayer, SoftplusLayer, XeluLayer, InsanityLayer, PReluLayer,
             BiasLayer, ConvolutionLayer, MaxPoolingLayer,
             ReluMaxPoolingLayer, SumPoolingLayer, AvgPoolingLayer,
             InsanityPoolingLayer, LRNLayer, FullConnectLayer,
             FixConnectLayer, BatchNormLayer, DropoutLayer, SoftmaxLayer,
             L2LossLayer, MultiLogisticLayer, EmbeddingLayer, LayerNormLayer,
             SeqFullcLayer, AttentionLayer, SoftmaxSeqLayer, MoELayer):
    register(_cls)


def _register_plugins() -> None:
    # the plugin layer (caffe-adapter analogue) imports layers through
    # this module, so it registers after them
    from ..plugin.torch_adapter import TorchLayer
    register(TorchLayer)


_register_plugins()

#: plugin layer types: their keys are their sections' only
PLUGIN_TYPES = ("torch",)

#: layers of the JAX package that the port does not implement yet (none
#: since the moe layer came with the expert axis)
NOT_PORTED: tuple = ()


def layer_type_names():
    return sorted(_REGISTRY)


def is_not_ported(type_name: str) -> bool:
    if type_name.startswith("pairtest-"):
        return any(is_not_ported(t) for t in
                   type_name[len("pairtest-"):].split("-", 1))
    return type_name in NOT_PORTED


def not_ported_message(type_name: str) -> str:
    """The refusal of a layer type the port lacks (the runtime's and
    ``task = check``'s words)."""
    return (f"layer type {type_name!r} is not ported to cxxnet_tpu_torch "
            "yet (ROADMAP.md)")


def create_layer(type_name: str) -> Layer:
    """Create a layer from its config type name."""
    if type_name.startswith("pairtest-"):
        # reference format: pairtest-<master>-<slave>
        master, slave = type_name[len("pairtest-"):].split("-", 1)
        return PairTestLayer(create_layer(master), create_layer(slave))
    if type_name.startswith("share"):
        raise ValueError("shared layers are resolved by the net graph")
    if is_not_ported(type_name):
        raise ValueError(not_ported_message(type_name))
    if type_name not in _REGISTRY:
        raise ValueError(f"unknown layer type: {type_name!r} (not ported to "
                         f"cxxnet_tpu_torch yet?); known: "
                         f"{layer_type_names()}")
    return _REGISTRY[type_name]()

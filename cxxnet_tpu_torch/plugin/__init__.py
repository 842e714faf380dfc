"""Plugin layers adapting external implementations behind the Layer
interface (the JAX package's ``plugin/``).

Reference: ``src/plugin/caffe_adapter-inl.hpp`` — cxxnet wraps
``caffe::Layer`` objects behind ``ILayer`` so Caffe's implementations can
run inside a cxxnet net, primarily as a known-good oracle for PairTest
differential testing (``caffe_adapter-inl.hpp:23-24``).  The port's
``torch`` layer is that oracle: plain ``torch.nn.functional`` under
autograd, on the layer's own device, never through the port's kernels.
"""

from .torch_adapter import TorchLayer

__all__ = ["TorchLayer"]

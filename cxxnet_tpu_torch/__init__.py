"""cxxnet_tpu_torch: the PyTorch / CUDA port of cxxnet_tpu.

Same ``key = value`` config surface and CLI as the JAX package
(``python -m cxxnet_tpu_torch <conf> [key=value ...]``), running on an
NVIDIA GPU through PyTorch, with the JAX package's Pallas kernels
rewritten by hand in CUDA C++ for Hopper (``ops/csrc``).

The port grows slice by slice (ROADMAP.md).  It serves the transformer
LM (``task = serve`` with ``serve_gen = 1``: KV-cached incremental
decode with token-level continuous batching) and trains it (``task =
train``, packed documents, the hand-written flash-attention and
layernorm backward kernels).  Entry points run on the card unless the
config asks for ``dev = cpu``.
"""

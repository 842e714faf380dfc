"""Hand-written kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA tensor (or raises) and
runs the plain version for a CPU tensor; ``<wrapper>.launches`` counts
kernel launches.  Kernels build from ``csrc/`` at first use
(:mod:`.build`).
"""

"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each ``*_cuda.py`` wrapper checks its inputs, launches its ``csrc/*.cu``
kernel for CUDA tensors (counting launches in ``<wrapper>.launches``) and
takes the plain version only for CPU tensors. Sources are compiled on first
use by ``_build``; importing these modules compiles nothing.
"""

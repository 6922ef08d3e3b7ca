"""Hand-written Hopper kernels, their plain oracles and their build.

Nothing here builds or loads a kernel at import time: ``build.load``
compiles a kernel's CUDA source with ``nvcc`` at its first launch.
"""

"""PyTorch/CUDA port of the CHASE-CI reproduction (the JAX package
``repro`` stays beside it as the reference).

The port grows slice by slice; see ROADMAP.md.  Its serving path runs
``phi4-mini-3.8b`` on one NVIDIA H100 with a hand-written CUDA
flash-attention prefill kernel.  Importing the package imports nothing
heavy: kernels are built at their first launch.
"""

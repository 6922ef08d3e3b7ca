"""Runnable twins of the repo's examples on the port (``python -m
repro_torch.examples.<name> [--device cpu]``)."""

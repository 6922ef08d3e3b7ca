"""``--arch <id>`` registry of the architectures the port runs.

It lists only what the port can run today; each later slice adds the archs
whose block kinds it ports.  phi4 serves and trains; zamba2, rwkv6 and
granite-moe serve (their training raises ``NotImplementedError``).
``get_parallel`` returns an arch's ``PARALLEL`` (or the default), as in the
JAX registry.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig, smoke_config

ARCHS: Tuple[str, ...] = ("phi4-mini-3.8b", "zamba2-2.7b", "rwkv6-1.6b",
                          "granite-moe-1b-a400m")

_MODULES = {"phi4-mini-3.8b": "phi4_mini_3_8b",
            "zamba2-2.7b": "zamba2_2_7b",
            "rwkv6-1.6b": "rwkv6_1_6b",
            "granite-moe-1b-a400m": "granite_moe_1b_a400m"}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_parallel(arch: str) -> ParallelConfig:
    return getattr(_module(arch), "PARALLEL", ParallelConfig())


def get_smoke(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))

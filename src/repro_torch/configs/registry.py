"""``--arch <id>`` registry of the architectures the port runs.

It lists only what the port can serve today; each later slice adds the
archs whose block kinds it ports.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ModelConfig, smoke_config

ARCHS: Tuple[str, ...] = ("phi4-mini-3.8b",)

_MODULES = {"phi4-mini-3.8b": "phi4_mini_3_8b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))

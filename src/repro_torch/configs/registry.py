"""``--arch <id>`` registry of the architectures the port runs.

All ten of the JAX registry's, and each serves and trains: phi4,
codeqwen1.5-7b, deepseek-7b and gemma2-9b (dense attention; gemma2 with
its sliding window and softcaps), zamba2 (Mamba2 with shared attention),
rwkv6, granite-moe and kimi-k2-1t-a32b (top-k MoE; kimi at head dim 112,
with its int8 + factored optimizer state), whisper-small (the
encoder-decoder, ``models.encdec``) and llama-3.2-vision-90b (gated cross
attention, ``models.vlm``).  ``get_optimizer`` and
``get_parallel`` return an arch's ``OPTIMIZER`` and ``PARALLEL`` (or the
defaults), and ``cells`` lists the dry run's (arch, shape) cells, as in
the JAX registry.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      smoke_config)

ARCHS: Tuple[str, ...] = ("phi4-mini-3.8b", "codeqwen1.5-7b", "deepseek-7b",
                          "gemma2-9b", "zamba2-2.7b", "whisper-small",
                          "rwkv6-1.6b", "granite-moe-1b-a400m",
                          "kimi-k2-1t-a32b", "llama-3.2-vision-90b")

_MODULES = {"phi4-mini-3.8b": "phi4_mini_3_8b",
            "codeqwen1.5-7b": "codeqwen1_5_7b",
            "deepseek-7b": "deepseek_7b",
            "gemma2-9b": "gemma2_9b",
            "zamba2-2.7b": "zamba2_2_7b",
            "whisper-small": "whisper_small",
            "rwkv6-1.6b": "rwkv6_1_6b",
            "granite-moe-1b-a400m": "granite_moe_1b_a400m",
            "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
            "llama-3.2-vision-90b": "llama_3_2_vision_90b"}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_optimizer(arch: str) -> OptimizerConfig:
    return getattr(_module(arch), "OPTIMIZER", OptimizerConfig())


def get_parallel(arch: str) -> ParallelConfig:
    return getattr(_module(arch), "PARALLEL", ParallelConfig())


def get_smoke(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))


def cells(include_skipped: bool = False):
    """Every (arch, shape, skipped) dry-run cell, honoring the long_500k
    rule: only the sub-quadratic archs (``LONG_CONTEXT_ARCHS``) lower it."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skipped = (shape.name == "long_500k"
                       and arch not in LONG_CONTEXT_ARCHS)
            if skipped and not include_skipped:
                continue
            out.append((arch, shape, skipped))
    return out

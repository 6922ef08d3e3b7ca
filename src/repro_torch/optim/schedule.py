"""LR schedules as pure functions of the step counter (a device tensor).

A port of the JAX package's ``optim/schedule.py``: linear warmup, then
cosine, linear or constant decay.  ``step`` stays on its device and nothing
here reads it back, so a training step makes no host sync for its
learning rate.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def learning_rate(ocfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at ``step`` (a tensor; 1 is the first step)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = max(ocfg.warmup_steps, 1)
    warmup = step / warm
    if ocfg.schedule == "constant":
        decay = torch.ones_like(step)
    else:
        t = ((step - warm) / max(ocfg.decay_steps - warm, 1)).clamp(0, 1)
        if ocfg.schedule == "linear":
            decay = 1.0 - t
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    return ocfg.lr * warmup.clamp(max=1.0) * torch.where(
        step < warm, torch.ones_like(decay), decay)

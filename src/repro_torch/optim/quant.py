"""Blockwise int8 quantization of optimizer moments, on tensors.

A port of the JAX package's ``optim/quant.py`` with its arithmetic kept:
blocks of ``BLOCK`` (128) along the last axis when it divides, else the
whole last axis; symmetric absmax scales ``s = max|x| / 127``, floored at
1e-12 and stored in f32; ``q = clip(round(x / s), -127, 127)`` as int8,
rounding half to even (``torch.round``, as ``jnp.round``).  Every step
is a correctly rounded f32 operation, so the card, the CPU and JAX give
the same bits.  A moment is
stored as ``{"q": int8 like x, "s": f32 (..., blocks)}``; a 0-d tensor
takes the (1, 1) path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

BLOCK = 128


def block_size(last_dim: int) -> int:
    return BLOCK if last_dim % BLOCK == 0 else last_dim


def quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x (any float dtype) -> {"q": int8 of x's shape, "s": f32 scales}."""
    if x.dim():
        b = block_size(x.shape[-1])
        xb = x.reshape(x.shape[:-1] + (x.shape[-1] // b, b))
    else:
        xb = x.reshape(1, 1)
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    # a true division: on CUDA, dividing by a Python number multiplies by
    # its reciprocal, which rounds some scales one step from x / 127
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "s": s[..., 0].to(torch.float32)}


def dequantize(qs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{"q", "s"} -> the f32 tensor of q's shape."""
    q, s = qs["q"], qs["s"]
    if q.dim() == 0:
        return q.to(torch.float32) * s.reshape(())
    b = q.shape[-1] // max(s.shape[-1], 1)
    qb = q.reshape(q.shape[:-1] + (s.shape[-1], b)).to(torch.float32)
    return (qb * s[..., None]).reshape(q.shape)


def quantized_shapes(shape: Tuple[int, ...]):
    """(q_shape, s_shape) for a tensor of ``shape``."""
    shape = tuple(shape)
    if not shape:
        return shape, ()
    b = block_size(shape[-1])
    return shape, shape[:-1] + (shape[-1] // b,)

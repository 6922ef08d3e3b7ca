"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Numerics mirror the JAX package's ``models/layers.py`` exactly: RMSNorm
takes the variance in f32 and multiplies in x's dtype by ``1 + scale``;
RoPE is split-half (not interleaved); SiLU runs in f32.  There is no mesh,
so the JAX sharding constraints have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import torch_dtype


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: f32 variance, multiply in x.dtype, scale by ``1 + scale``."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding.  x: (B, S, N, dh); positions (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[None, :, None].float() * freqs      # (1,S,half)
    else:
        ang = positions[:, :, None].float() * freqs         # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def swiglu(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """p: {"wg","wu": (D, F), "wo": (F, D)}; SiLU in f32."""
    cd = compute_dtype(cfg)
    gate = x @ p["wg"].to(cd)
    up = x @ p["wu"].to(cd)
    h = torch.nn.functional.silu(gate.float()).to(cd) * up
    return h @ p["wo"].to(cd)


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    cd = compute_dtype(cfg)
    x = embed.to(cd)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=x.device)
    return x


def unembed(cfg: ModelConfig, embed_or_head: torch.Tensor, x: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    w = embed_or_head.to(compute_dtype(cfg))
    logits = x @ (w.t() if transpose else w)
    return softcap(logits, cfg.final_logit_softcap)

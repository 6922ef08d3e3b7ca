"""GQA attention: projections, prefill attention and one-token decode.

Prefill (``causal_attention``) runs the port's flash kernel
(``repro_torch.kernels.flash_attention``) on CUDA tensors, and the same
wrapper's plain version (``ref.attention_ref`` with KV heads expanded) on
CPU tensors.  The JAX package computes the same function in XLA
(``models/attention.py`` ``_qchunk_attention``); its Pallas kernel is the
hot-spot form of it.  Decode (``decode_attention``) is plain PyTorch, like
the reference's XLA decode; a paged-decode kernel is later work.

GQA grouping follows the JAX reshape of H into (KV, g): query head h reads
KV head ``h // (H // KV)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import compute_dtype, rope, softcap

NEG_INF = -1e30


def qkv_proj(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KV,dh), RoPE'd."""
    cd = compute_dtype(cfg)
    B, S, D = x.shape

    def proj(w):
        return (x @ w.to(cd).reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.attn.use_rope:
        q = rope(q, positions, cfg.attn.rope_theta)
        k = rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def _unsupported(window, logit_softcap):
    if window is not None or logit_softcap is not None:
        raise NotImplementedError(
            "sliding-window and softcapped attention (gemma2) arrive with "
            "the gemma2 slice of the port (ROADMAP queue A, other model "
            "families); the flash kernel has neither yet")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,dh); k,v (B,Sk,KV,dh) -> (B,Sq,H,dh)."""
    _unsupported(window, logit_softcap)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     causal: bool = True) -> torch.Tensor:
    """One-token attention against a (B,S,KV,dh) cache.  ``pos`` is a
    scalar or a (B,) tensor: row b sees cache positions <= pos[b]."""
    _unsupported(window, logit_softcap)
    B, _, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = dh ** -0.5
    qr = q.reshape(B, KV, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float() * scale
    kpos = torch.arange(S, device=q.device)
    pos_col = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    mask = kpos[None] <= pos_col                     # (1|B, S)
    if not causal:
        mask = torch.ones_like(mask)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    num = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v_cache)
    den = p.sum(dim=-1)
    out = num.float() / den[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def attn_out(cfg: ModelConfig, p, attn: torch.Tensor) -> torch.Tensor:
    B, S, H, dh = attn.shape
    wo = p["wo"].to(compute_dtype(cfg))
    return attn.reshape(B, S, H * dh) @ wo.reshape(H * dh, -1)

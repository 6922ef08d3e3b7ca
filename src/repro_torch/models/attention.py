"""GQA attention: projections, prefill, training and one-token decode.

Prefill (``causal_attention``) runs the port's flash kernel
(``repro_torch.kernels.flash_attention``) on CUDA tensors, and the same
wrapper's plain version (``attention_plain``: the oracle with KV heads
expanded and P rounded as the kernel rounds it) on CPU tensors, with
gemma2's sliding window and logit softcap
and, with ``causal=False``, the encoders' and cross attention's unmasked
Sq != Sk case.  The JAX package computes the same function in XLA
(``models/attention.py`` ``_qchunk_attention``); its Pallas kernel is the
hot-spot form of it.  Training (``train_attention``) is a plain PyTorch
port of ``_qchunk_attention``, differentiable, because the JAX package
trains through that XLA function and never through its Pallas kernel,
which has no backward; a flash backward kernel is later work.  Decode
(``decode_attention``) is plain PyTorch, like the reference's XLA decode;
a paged-decode kernel is later work.

GQA grouping follows the JAX reshape of H into (KV, g): query head h reads
KV head ``h // (H // KV)``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,dh); k,v (B,Sk,KV,dh) -> (B,Sq,H,dh).  ``window`` applies
    only when ``causal``, as in the JAX model's mask."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          softcap=logit_softcap)
    return out.transpose(1, 2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: Optional[int],
          causal: bool = True) -> torch.Tensor:
    if not causal:
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    m = kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    chunk: int = 512, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,dh); k,v (B,Sk,KV,dh) -> (B,Sq,H,dh), differentiable;
    causal (top-left aligned, as the JAX model's mask) unless ``causal`` is
    False (encoders, cross attention).

    The reference's q-chunked attention (``_qchunk_attention``): scores in
    f32 after the product in the compute dtype, the -1e30 mask, the
    softmax in f32, probabilities cast to ``v.dtype`` before the PV
    product.  Under autograd each q chunk is checkpointed, as the reference
    checkpoints it, so backward recomputes a chunk's probabilities instead
    of keeping (S, S) of them per layer.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KV, H // KV, dh)
    scale = dh ** -0.5
    chunk = min(chunk, Sq)
    if Sq % chunk:
        chunk = Sq
    kpos = torch.arange(Sk, device=q.device)

    def one(i: int) -> torch.Tensor:
        qs = qr[:, i * chunk:(i + 1) * chunk]
        s = torch.einsum("bckgd,bskd->bkgcs", qs, k).float() * scale
        s = softcap(s, logit_softcap)
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        s = torch.where(_mask(qpos, kpos, window, causal)[None, None, None],
                        s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bkgcs,bskd->bckgd", p, v)

    grad = torch.is_grad_enabled()
    outs = [checkpoint(one, i, use_reentrant=False, preserve_rng_state=False)
            if grad else one(i) for i in range(Sq // chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     causal: bool = True) -> torch.Tensor:
    """One-token attention against a (B,S,KV,dh) cache.  ``pos`` is a
    scalar or a (B,) tensor: row b sees cache positions <= pos[b], and
    under a window only those > pos[b] - window; ``causal=False`` sees the
    whole cache (cross attention).  The softcap follows the scale."""
    B, _, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = dh ** -0.5
    qr = q.reshape(B, KV, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float() * scale
    s = softcap(s, logit_softcap)
    kpos = torch.arange(S, device=q.device)
    pos_col = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    mask = kpos[None] <= pos_col                     # (1|B, S)
    if not causal:
        mask = torch.ones_like(mask)
    if window is not None and causal:
        mask &= kpos[None] > pos_col - window
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

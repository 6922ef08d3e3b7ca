"""Gated cross-attention image blocks (llama-3.2-vision), in PyTorch.

A port of the JAX package's ``models/vlm.py``.  The vision tower is a
stub: ``extras["image_embeds"]`` holds precomputed patch embeddings
(B, P, vision_dim); a ``cross`` block projects them to K/V and
cross-attends with tanh-gated residuals.  In prefill the cross attention
(Sq = S queries against Sk = P patches, unmasked) runs the port's flash
kernel through ``attention.causal_attention(..., causal=False)``, and the
block's K/V go into the cache; in decode they are constants read back from
it, and the one query row runs the plain ``decode_attention`` with
``causal=False`` (the JAX model runs its non-causal q-chunked attention
there with Sq = 1, the same function).  Training runs the plain
``train_attention`` unmasked.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import compute_dtype, rms_norm, swiglu
from repro_torch.models.params import PSpec


def cross_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, H, KV, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    Vd = cfg.vision_dim
    heads_div = H % 16 == 0
    hq = "tp_heads" if heads_div else None
    hd_ax = "head_dim" if heads_div else "tp_head_dim"
    return {
        "ln1": PSpec((G, D), ("layers", None), "zeros"),
        "wq": PSpec((G, D, H, dh), ("layers", "fsdp", hq, hd_ax)),
        "wk": PSpec((G, Vd, KV, dh), ("layers", None, "tp_kv_heads", hd_ax)),
        "wv": PSpec((G, Vd, KV, dh), ("layers", None, "tp_kv_heads", hd_ax)),
        "k_norm": PSpec((G, dh), ("layers", None), "zeros"),
        "q_norm": PSpec((G, dh), ("layers", None), "zeros"),
        "wo": PSpec((G, H, dh, D), ("layers", hq, hd_ax, "fsdp")),
        "gate_attn": PSpec((G,), ("layers",), "zeros"),
        "ln2": PSpec((G, D), ("layers", None), "zeros"),
        "wg": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wu": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wo_mlp": PSpec((G, F, D), ("layers", "tp_ff", "fsdp")),
        "gate_mlp": PSpec((G,), ("layers",), "zeros"),
    }


def cross_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    """The cross K/V: P = num_patches rows a slot, whatever S is (so the
    cache never pages)."""
    KV, dh, P = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_patches
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"ck": PSpec((G, B, P, KV, dh), ax, "zeros"),
            "cv": PSpec((G, B, P, KV, dh), ax, "zeros")}


def _gate(g: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return torch.tanh(g.float()).to(cd)


def apply_cross(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
                shared, extras=None):
    """-> (x, new_cache): prefill's cross K/V, decode's cache as given (its
    K/V are constants), {} in train."""
    cd = compute_dtype(cfg)
    B, S, D = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    wq = p["wq"].to(cd)
    q = (h @ wq.reshape(D, -1)).view(B, S, wq.shape[1], wq.shape[2])
    q = rms_norm(q, p["q_norm"], cfg.norm_eps)

    if mode == "decode":
        k, v = cache["ck"].to(cd), cache["cv"].to(cd)
        out = attn_mod.decode_attention(q, k, v, 0, causal=False)
        new_cache = cache
    else:
        if extras is None or "image_embeds" not in extras:
            raise ValueError("a cross block needs extras['image_embeds'] "
                             "(B, num_patches, vision_dim) in prefill and "
                             "train (runtime.steps.extras_specs)")
        img = extras["image_embeds"].to(cd)             # (B, P, Vd)
        Bi, P, Vd = img.shape
        wk, wv = p["wk"].to(cd), p["wv"].to(cd)
        k = (img @ wk.reshape(Vd, -1)).view(Bi, P, wk.shape[1], wk.shape[2])
        v = (img @ wv.reshape(Vd, -1)).view(Bi, P, wv.shape[1], wv.shape[2])
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if mode == "train":
            out = attn_mod.train_attention(q, k, v, causal=False)
            new_cache = {}
        else:
            out = attn_mod.causal_attention(q, k, v, causal=False)
            new_cache = {"ck": k, "cv": v}
    out = attn_mod.attn_out(cfg, p, out)
    x = x + _gate(p["gate_attn"], cd) * out

    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    mlp = swiglu(cfg, {"wg": p["wg"], "wu": p["wu"], "wo": p["wo_mlp"]}, h2)
    return x + _gate(p["gate_mlp"], cd) * mlp, new_cache

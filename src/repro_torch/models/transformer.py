"""Decoder-only LM over layer groups, for the dense attention kinds.

The schema is the JAX package's (``models/transformer.py``): parameters of
each block kind in ``cfg.block_pattern`` are stacked along a leading group
axis G, and caches are (G, B, S, KV, dh).  The JAX model scans over groups;
here ``forward`` is a Python loop over the group axis.

This slice ports the kinds ``attn``/``global``/``local`` in the modes
``prefill`` and ``decode``.  Training mode and the MoE, SSM, VLM and
enc-dec kinds come with later slices.

Decode writes the step's k/v into the cache tensors in place (the JAX
functions return new caches); callers that need the old cache clone it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import embed_tokens, rms_norm, swiglu, unembed
from repro_torch.models.params import PSpec

DENSE_KINDS = ("attn", "global", "local")


def _check_kinds(cfg: ModelConfig) -> None:
    other = [k for k in cfg.block_pattern if k not in DENSE_KINDS]
    if other:
        raise NotImplementedError(
            f"block kinds {other} are not ported yet; the port runs "
            f"{DENSE_KINDS}")


def _attn_mlp_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, H, KV, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    heads_div = H % 16 == 0
    hq = "tp_heads" if heads_div else None
    hd = "head_dim" if heads_div else "tp_head_dim"
    s: Dict[str, PSpec] = {
        "ln1": PSpec((G, D), ("layers", None), "zeros"),
        "wq": PSpec((G, D, H, dh), ("layers", "fsdp", hq, hd)),
        "wk": PSpec((G, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd)),
        "wv": PSpec((G, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd)),
        "wo": PSpec((G, H, dh, D), ("layers", hq, hd, "fsdp")),
        "ln2": PSpec((G, D), ("layers", None), "zeros"),
        "wg": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wu": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wo_mlp": PSpec((G, F, D), ("layers", "tp_ff", "fsdp")),
    }
    if cfg.attn.qkv_bias:
        s["bq"] = PSpec((G, H, dh), ("layers", "tp_heads", "head_dim"), "zeros")
        s["bk"] = PSpec((G, KV, dh), ("layers", "tp_kv_heads", "head_dim"), "zeros")
        s["bv"] = PSpec((G, KV, dh), ("layers", "tp_kv_heads", "head_dim"), "zeros")
    if cfg.post_norm:
        s["ln1_post"] = PSpec((G, D), ("layers", None), "zeros")
        s["ln2_post"] = PSpec((G, D), ("layers", None), "zeros")
    return s


def _attn_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    KV, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": PSpec((G, B, S, KV, dh), ax, "zeros"),
            "v": PSpec((G, B, S, KV, dh), ax, "zeros")}


def lm_schema(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kinds(cfg)
    G = cfg.num_groups
    schema: Dict[str, Any] = {
        "embed": PSpec((cfg.vocab_size, cfg.d_model), ("tp_vocab", "fsdp"),
                       scale=0.02),
        "blocks": {f"{i}_{kind}": _attn_mlp_schema(cfg, G)
                   for i, kind in enumerate(cfg.block_pattern)},
        "final_norm": PSpec((cfg.d_model,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = PSpec((cfg.vocab_size, cfg.d_model),
                                  ("tp_vocab", "fsdp"))
    return schema


def cache_schema(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    _check_kinds(cfg)
    G = cfg.num_groups
    return {f"{i}_{kind}": _attn_cache_schema(cfg, B, S, G)
            for i, kind in enumerate(cfg.block_pattern)}


def insert_kv(cache, k, v, pos) -> None:
    """Write this step's k/v (B,1,KV,dh) into ``cache`` (B,S,KV,dh) in place.

    ``pos`` is a scalar (every row at one position, clamped to the cache
    like ``dynamic_update_slice``) or a (B,) tensor (each slot at its own
    position).  A vector entry >= the cache length writes nothing.
    """
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        at = min(max(int(pos), 0), S - 1)
        kc[:, at] = k[:, 0]
        vc[:, at] = v[:, 0]
        return
    rows = torch.arange(kc.shape[0], device=kc.device)
    at = pos.clamp(0, S - 1)
    hit = (pos < S)[:, None, None]
    kc[rows, at] = torch.where(hit, k[:, 0].to(kc.dtype), kc[rows, at])
    vc[rows, at] = torch.where(hit, v[:, 0].to(vc.dtype), vc[rows, at])


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn.window if kind == "local" else None


def _attn_block(cfg: ModelConfig, kind: str, p, x, *, mode, positions,
                cache, pos):
    """Pre-norm attention + SwiGLU MLP; returns (x, prefill k/v or None)."""
    window = _window(cfg, kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn_mod.qkv_proj(cfg, p, h, positions)
    new_kv = None
    if mode == "decode":
        insert_kv(cache, k, v, pos)
        out = attn_mod.decode_attention(
            q, cache["k"], cache["v"], pos, window=window,
            logit_softcap=cfg.attn.logit_softcap)
    else:
        out = attn_mod.causal_attention(
            q, k, v, window=window, logit_softcap=cfg.attn.logit_softcap)
        new_kv = (k, v)
    out = attn_mod.attn_out(cfg, p, out)
    if cfg.post_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    out = swiglu(cfg, {"wg": p["wg"], "wu": p["wu"], "wo": p["wo_mlp"]}, h)
    if cfg.post_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out, new_kv


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", caches=None, pos=None):
    """tokens (B,St) int.  prefill: St = S; decode: St = 1.

    Returns (final hidden states (B,St,D), caches).  Prefill returns new
    caches whose sequence axis covers the prompt; decode writes into
    ``caches`` in place and returns them.
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: the port runs prefill and decode; training "
            f"comes with the training slice")
    _check_kinds(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    if mode == "decode":
        p = torch.as_tensor(pos, device=tokens.device)
        positions = p[:, None] if p.dim() == 1 else p.reshape(1)
    else:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    kvs: Dict[str, list] = {}
    for gi in range(cfg.num_groups):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}_{kind}"
            p = {name: leaf[gi] for name, leaf in params["blocks"][key].items()}
            cache = (None if caches is None else
                     {name: leaf[gi] for name, leaf in caches[key].items()})
            x, kv = _attn_block(cfg, kind, p, x, mode=mode,
                                positions=positions, cache=cache, pos=pos)
            if kv is not None:
                kvs.setdefault(key, []).append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        caches = {key: {"k": torch.stack([k for k, _ in layers]),
                        "v": torch.stack([v for _, v in layers])}
                  for key, layers in kvs.items()}
    return x, caches


def lm_head(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits for a few positions (serving), with tied embeddings."""
    return unembed(cfg, lm_head(cfg, params), x, transpose=True)

"""Whisper-style encoder-decoder backbone (family "audio"), in PyTorch.

A port of the JAX package's ``models/encdec.py``.  The conv/mel frontend
is a stub: ``extras["frames"]`` holds precomputed frame embeddings
(B, T_enc, d_model).  The encoder is bidirectional; the decoder is causal
self-attention plus cross attention to the encoder output.  In prefill
every attention runs the port's flash kernel: the encoder's self-attention
unmasked (Sq = Sk = T_enc), the decoder's causal, and its cross attention
unmasked with Sq = the decoder tokens and Sk = T_enc, so a prefill
launches it 3 times a layer pair (36 at whisper-small's 12 + 12).  Decode
is plain PyTorch (``attention.decode_attention``): the self cache of
``decoder_len`` positions, and the cross K/V cached at prefill, read
whole (``pos=0, causal=False``), as in the reference.

The module mirrors ``models.transformer``'s API (``lm_schema``,
``cache_schema``, ``forward``, ``lm_head``, ``lm_logits``, ``loss_fn``),
so ``runtime.steps`` dispatches by ``cfg.family``.  As there, prefill
returns new caches, decode writes into the given ones in place, and train
keeps the autograd graph and remats each layer under ``par.remat``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import losses
from repro_torch.models.layers import compute_dtype, rms_norm, swiglu, unembed
from repro_torch.models.params import PSpec
from repro_torch.models.transformer import (_attn_mlp_schema, _index, _stack,
                                            insert_kv)


def lm_schema(cfg: ModelConfig) -> Dict[str, Any]:
    Ge = cfg.encoder_layers
    Gd = cfg.num_layers
    dec_blocks = _attn_mlp_schema(cfg, Gd)
    D, KV, dh = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    H = cfg.num_heads
    heads_div = H % 16 == 0
    hq = "tp_heads" if heads_div else None
    hd_ax = "head_dim" if heads_div else "tp_head_dim"
    dec_blocks.update({
        "ln_x": PSpec((Gd, D), ("layers", None), "zeros"),
        "xwq": PSpec((Gd, D, H, dh), ("layers", "fsdp", hq, hd_ax)),
        "xwk": PSpec((Gd, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd_ax)),
        "xwv": PSpec((Gd, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd_ax)),
        "xwo": PSpec((Gd, H, dh, D), ("layers", hq, hd_ax, "fsdp")),
    })
    return {
        "embed": PSpec((cfg.vocab_size, D), ("tp_vocab", "fsdp"), scale=0.02),
        "pos_dec": PSpec((cfg.decoder_len, D), (None, None), scale=0.02),
        "enc_blocks": _attn_mlp_schema(cfg, Ge),
        "enc_norm": PSpec((D,), (None,), "zeros"),
        "dec_blocks": dec_blocks,
        "final_norm": PSpec((D,), (None,), "zeros"),
    }


def cache_schema(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    """The decoder's self cache (``decoder_len`` positions whatever S is,
    its sequence axis not named ``cache_seq``) and the cross K/V of S
    encoder frames: neither pages."""
    G = cfg.num_layers
    KV, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    self_ax = ("layers", "batch", None, "kv_heads", "head_dim")
    return {
        "self": {"k": PSpec((G, B, cfg.decoder_len, KV, dh), self_ax, "zeros"),
                 "v": PSpec((G, B, cfg.decoder_len, KV, dh), self_ax, "zeros")},
        "cross": {"ck": PSpec((G, B, S, KV, dh), ax, "zeros"),
                  "cv": PSpec((G, B, S, KV, dh), ax, "zeros")},
    }


def _sinusoid(S: int, D: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)[:, None].float()
    dim = torch.arange(D // 2, device=device)[None, :].float()
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) @ w (D,N,dh) -> (B,S,N,dh)."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def _self_block(cfg: ModelConfig, p, x, *, causal: bool, mode: str,
                cache=None, pos=None):
    """Pre-norm self-attention (no RoPE: whisper's positions are added to
    the embeddings) and the SwiGLU MLP.  -> (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = attn_mod.qkv_proj(cfg, p, h, positions)
    new_cache = {}
    if mode == "decode":
        insert_kv(cache, k, v, pos)
        out = attn_mod.decode_attention(q, cache["k"], cache["v"], pos)
        new_cache = cache
    elif mode == "train":
        out = attn_mod.train_attention(q, k, v, causal=causal)
    else:
        out = attn_mod.causal_attention(q, k, v, causal=causal)
        new_cache = {"k": k, "v": v}
    x = x + attn_mod.attn_out(cfg, p, out)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(cfg, {"wg": p["wg"], "wu": p["wu"], "wo": p["wo_mlp"]},
                      h2), new_cache


def _cross_part(cfg: ModelConfig, p, x, *, enc_out=None, cache=None,
                mode: str):
    """Decoder cross attention to the encoder output (or its cached K/V).
    -> (x, new_cache)."""
    cd = compute_dtype(cfg)
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    q = _proj(h, p["xwq"].to(cd))
    if mode == "decode":
        k, v = cache["ck"].to(cd), cache["cv"].to(cd)
        out = attn_mod.decode_attention(q, k, v, 0, causal=False)
        new_cache = cache
    else:
        k = _proj(enc_out, p["xwk"].to(cd))
        v = _proj(enc_out, p["xwv"].to(cd))
        if mode == "train":
            out = attn_mod.train_attention(q, k, v, causal=False)
            new_cache = {}
        else:
            out = attn_mod.causal_attention(q, k, v, causal=False)
            new_cache = {"ck": k, "cv": v}
    B, S, H, dh = out.shape
    xwo = p["xwo"].to(cd)
    return x + out.reshape(B, S, H * dh) @ xwo.reshape(H * dh, -1), new_cache


def _layers(tree, G: int, train: bool):
    """Per-group views of stacked leaves: an unbind per leaf in train (so
    backward stacks the grads in one op), an index otherwise."""
    if train:
        sl = {name: leaf.unbind(0) for name, leaf in tree.items()}
        return [{name: s[gi] for name, s in sl.items()} for gi in range(G)]
    return [{name: leaf[gi] for name, leaf in tree.items()} for gi in range(G)]


def _encode(cfg: ModelConfig, par: ParallelConfig, params,
            frames: torch.Tensor, mode: str) -> torch.Tensor:
    cd = compute_dtype(cfg)
    x = frames.to(cd)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    train = mode == "train"

    def body(x, gp):
        return _self_block(cfg, gp, x, causal=False, mode=mode)[0]

    for gp in _layers(params["enc_blocks"], cfg.encoder_layers, train):
        if train and par.remat:
            x = checkpoint(body, x, gp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, gp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", caches=None, pos=None,
            par: Optional[ParallelConfig] = None, extras=None):
    """tokens: decoder tokens (B, Td) (Td = 1 in decode); ``extras["frames"]``
    (B, T_enc, d_model) in prefill and train.

    Returns (decoder hidden states, caches): new caches in prefill, the
    given ones written in place in decode, None in train.
    """
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode {mode!r}: one of prefill, decode, train")
    par = par or ParallelConfig()
    cd = compute_dtype(cfg)
    Td = tokens.shape[1]
    x = params["embed"].to(cd)[tokens]
    last = cfg.decoder_len - 1
    if mode == "decode":
        p = torch.as_tensor(pos, device=tokens.device)
        # the reference's dynamic_slice clamps a scalar position into the
        # table; a slot past it (the engine never has one) reads the last
        # row.  A tensor index, so a 0-d pos is not read back to the host.
        idx = p.clamp(0, last).reshape(-1).long()
        pvec = params["pos_dec"].index_select(0, idx).to(cd)    # (B or 1, D)
        x = x + pvec[:, None]
        enc_out = None
    else:
        if extras is None or "frames" not in extras:
            raise ValueError("the encoder-decoder needs extras['frames'] "
                             "(B, T_enc, d_model) in prefill and train")
        x = x + params["pos_dec"].to(cd)[None, :Td]
        enc_out = _encode(cfg, par, params, extras["frames"], mode)
    train = mode == "train"

    def body(x, gp, gc):
        x, nc_self = _self_block(cfg, gp, x, causal=True, mode=mode,
                                 cache=None if gc is None else gc["self"],
                                 pos=pos)
        x, nc_cross = _cross_part(cfg, gp, x, enc_out=enc_out,
                                  cache=None if gc is None else gc["cross"],
                                  mode=mode)
        return x, {"self": nc_self, "cross": nc_cross}

    new = []
    for gi, gp in enumerate(_layers(params["dec_blocks"], cfg.num_layers,
                                    train)):
        gc = None if caches is None else _index(caches, gi)
        if train and par.remat:
            x = checkpoint(lambda x, gp: body(x, gp, None)[0], x, gp,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x, nc = body(x, gp, gc)
            new.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        caches = _stack(new)
    elif train:
        caches = None
    return x, caches


def lm_head(cfg: ModelConfig, params):
    return params["embed"]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    return unembed(cfg, params["embed"], x, transpose=True)


def loss_fn(cfg: ModelConfig, par: ParallelConfig, params, batch):
    """Mean token NLL of ``batch`` ({"tokens", "labels"}: (B, Td) int,
    "extras": {"frames"}), through the chunked cross-entropy as in the
    reference."""
    x, _ = forward(cfg, params, batch["tokens"], mode="train", par=par,
                   extras=batch["extras"])
    head = params["embed"].to(compute_dtype(cfg))
    return losses.chunked_cross_entropy(x, batch["labels"], head)

"""Analytic FLOP and byte accounting of a step, per (arch x shape) cell.

The JAX package's ``roofline/flops.py``, op for op, over the port's
schemas (``lm_schema``, ``opt_state_schema`` under every recipe: f32,
bf16 or int8 moments, full or factored v; ``cache_schema``), so its
numbers equal the reference's for every cell.  The formulas mirror the
implementation's plain paths: full-score attention including the masked
half (the plain attention computes every score; the flash kernel skips
the tiles right of the diagonal), MoE capacity padding, remat recompute
multipliers.  MODEL_FLOPS = 6·N·D (6·N_active·D for MoE; 2·N·D for
inference) is the useful-work yardstick beside them.

Cross-checked against ``torch.utils.flop_counter.FlopCounterMode`` on a
small unrolled train step (``tests/test_torch_roofline.py``), and per
cell by the dry run's meta trace (``launch.dryrun``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import param_bytes, param_count
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_mod


def _ceil(a, b):
    return -(-a // b)


@dataclass
class Accounting:
    fwd_flops_global: float = 0.0       # one forward pass, whole step
    step_flops_global: float = 0.0      # incl. bwd + remat recompute
    model_flops: float = 0.0            # 6 N_active D
    params: int = 0
    active_params: int = 0
    weight_bytes: int = 0
    opt_state_bytes: int = 0
    act_bytes_global: float = 0.0       # activation HBM traffic (approx)
    cache_bytes: int = 0                # KV/state cache (decode/prefill)

    def as_dict(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.__dict__.items()}


def _attn_block_flops(cfg, tokens, ctx_len, *, window=None):
    """Per-step global flops of one dense attention+mlp layer."""
    D, H, KV, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    proj = 2 * D * dh * (H + 2 * KV) + 2 * H * dh * D
    # the plain attention computes FULL ctx scores (causality by masking):
    # no /2.  The flash kernel skips the tiles right of the diagonal, so
    # on the card a causal prefill's mix is about half this.
    mix = 4 * ctx_len * H * dh
    mlp = 6 * D * F
    return tokens * (proj + mix + mlp)


def _moe_slot_factor(cfg, tokens_per_chip, tp=16):
    m = cfg.moe
    TK = tokens_per_chip * m.top_k
    cap = _ceil(TK, tp) * m.capacity_factor
    slots = tp * int(cap)
    e_local = max(m.num_experts // tp, 1)
    cap_e = _ceil(slots, e_local) * m.capacity_factor
    padded = e_local * int(cap_e)
    return padded / max(tokens_per_chip, 1)


def _moe_block_flops(cfg, tokens, ctx_len, tokens_per_chip):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    attn = _attn_block_flops(cfg, tokens, ctx_len) - tokens * 6 * D * F
    router = tokens * 2 * D * E
    sf = _moe_slot_factor(cfg, tokens_per_chip)
    experts = tokens * sf * 6 * D * F
    return attn + router + experts


def _mamba_block_flops(cfg, tokens):
    D = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * D
    Hs = d_in // s.head_dim
    hd, N, c, K = s.head_dim, s.state_dim, s.chunk, s.conv_kernel
    proj = 2 * D * (2 * d_in + 2 * N + Hs) + 2 * d_in * D
    mix = Hs * (2 * c * N + 2 * c * hd + 4 * N * hd) + 2 * K * d_in
    return tokens * (proj + mix)


def _rwkv_block_flops(cfg, tokens):
    D, F = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv.head_dim
    H = D // hd
    c = cfg.rwkv.chunk
    proj = 2 * D * D * 6 + 2 * D * 64 * 2 + 4 * D * F
    mix = H * (5 * c * hd + 4 * hd * hd)
    return tokens * (proj + mix)


def _cross_block_flops(cfg, tokens, batch):
    D, H, KV, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    P, Vd = cfg.num_patches, cfg.vision_dim
    qo = tokens * (2 * D * H * dh + 2 * H * dh * D)
    kv = batch * 2 * P * Vd * 2 * KV * dh
    mix = tokens * 4 * P * H * dh
    mlp = tokens * 6 * D * F
    return qo + kv + mix + mlp


def forward_flops(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> float:
    """One forward pass, global flops, for THIS implementation."""
    B = shape.global_batch
    if shape.kind == "decode":
        tokens, ctx = B, shape.seq_len
    else:
        tokens, ctx = B * shape.seq_len, shape.seq_len
    if cfg.family == "audio":
        return _whisper_forward(cfg, shape)
    tokens_per_chip = max(tokens // chips * 16, 1)   # per model-row tokens
    total = 0.0
    G = cfg.num_groups
    for kind in cfg.block_pattern:
        if kind in ("attn", "global"):
            total += G * _attn_block_flops(cfg, tokens, ctx)
        elif kind == "local":
            w = cfg.attn.window or ctx
            total += G * _attn_block_flops(cfg, tokens, min(w, ctx))
        elif kind == "moe":
            total += G * _moe_block_flops(cfg, tokens, ctx, tokens_per_chip)
        elif kind == "mamba":
            total += G * _mamba_block_flops(cfg, tokens)
        elif kind == "mamba_attn":
            total += G * (_mamba_block_flops(cfg, tokens)
                          + _attn_block_flops(cfg, tokens, ctx))
        elif kind == "rwkv":
            total += G * _rwkv_block_flops(cfg, tokens)
        elif kind == "cross":
            total += G * _cross_block_flops(cfg, tokens, B)
        else:
            raise ValueError(kind)
    # head (train computes it on all tokens; serving on the last/new token)
    head_tokens = tokens if shape.kind == "train" else B
    total += head_tokens * 2 * cfg.d_model * cfg.vocab_size
    return total


def _whisper_forward(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B = shape.global_batch
    S_enc = shape.seq_len
    Td = 1 if shape.kind == "decode" else cfg.decoder_len
    enc_tokens = 0 if shape.kind == "decode" else B * S_enc
    enc = cfg.encoder_layers * _attn_block_flops(cfg, enc_tokens, S_enc)
    dec_self = cfg.num_layers * _attn_block_flops(
        cfg, B * Td, cfg.decoder_len)
    D, H, KV, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    kv_proj = 0 if shape.kind == "decode" else \
        cfg.num_layers * B * S_enc * 2 * D * 2 * KV * dh
    cross_mix = cfg.num_layers * B * Td * (
        2 * D * H * dh + 2 * H * dh * D + 4 * S_enc * H * dh)
    head = B * (Td if shape.kind == "train" else 1) * \
        2 * cfg.d_model * cfg.vocab_size
    return enc + dec_self + kv_proj + cross_mix + head


def train_multiplier(cfg: ModelConfig) -> float:
    """fwd-equivalents per train step: 1 fwd + 2 bwd + remat recompute
    (1 extra fwd; multi-layer groups pay a second recompute — nested)."""
    return 5.0 if len(cfg.block_pattern) > 1 else 4.0


def accounting(cfg: ModelConfig, shape: ShapeConfig, chips: int,
               ocfg=None) -> Accounting:
    cfg = steps_mod.resolve_cfg(cfg, shape)
    mod = steps_mod._model_module(cfg)
    schema = mod.lm_schema(cfg)
    acc = Accounting()
    acc.params = param_count(schema)
    if cfg.moe is not None:
        # active = total - (non-routed fraction of experts)
        expert_params = (cfg.num_groups * cfg.moe.num_experts *
                         3 * cfg.d_model * cfg.d_ff)
        active_experts = (cfg.num_groups * cfg.moe.top_k *
                          3 * cfg.d_model * cfg.d_ff)
        acc.active_params = acc.params - expert_params + active_experts
    else:
        acc.active_params = acc.params
    acc.weight_bytes = acc.params * 2                     # bf16

    if ocfg is not None:
        opt_schema = adamw.opt_state_schema(schema, ocfg)
        acc.opt_state_bytes = param_bytes(opt_schema, "float32")

    acc.fwd_flops_global = forward_flops(cfg, shape, chips)
    if shape.kind == "train":
        acc.step_flops_global = acc.fwd_flops_global * train_multiplier(cfg)
        tokens = shape.global_batch * shape.seq_len
        acc.model_flops = 6.0 * acc.active_params * tokens   # fwd+bwd
    else:
        acc.step_flops_global = acc.fwd_flops_global
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        acc.model_flops = 2.0 * acc.active_params * tokens   # inference fwd

    # --- HBM traffic (approx): weights read once per fwd-equivalent pass;
    # optimizer state read+write; activations ~ 12 (B,S,D)-sized tensors
    # per layer per pass (projection inputs/outputs, norms, residuals).
    D = cfg.d_model
    passes = train_multiplier(cfg) if shape.kind == "train" else 1.0
    act_pass = 12 * tokens * D * 2 * cfg.num_layers
    acc.act_bytes_global = passes * (acc.weight_bytes + act_pass)
    if shape.kind == "train":
        acc.act_bytes_global += 2 * acc.opt_state_bytes + acc.weight_bytes
    if shape.kind != "train":
        cache_schema = mod.cache_schema(cfg, shape.global_batch,
                                        shape.seq_len)
        acc.cache_bytes = param_bytes(cache_schema, cfg.param_dtype)
        acc.act_bytes_global += acc.cache_bytes  # decode reads whole cache
    return acc

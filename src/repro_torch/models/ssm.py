"""Sequence-mixing recurrences: Mamba2 (SSD), RWKV6 (WKV), zamba2 hybrid.

A port of the JAX package's ``models/ssm.py``: the same schemas, caches and
numerics.  The prefill scans run the port's kernels (``kernels.ssm_scan``
and ``kernels.wkv6``: hand-written CUDA on a CUDA tensor, their plain
transcriptions of the reference's ``_ssd_chunked``/``_wkv_chunked`` on a
CPU tensor), which also take an initial state and return the last one for
the decode cache.  Decode is plain PyTorch, one recurrence step, as in the
reference.

Decode updates the given cache views in place (the JAX functions return
new caches) and returns them.  Train mode runs the scans through
``ssm_scan.ssd_scan_train`` and ``wkv6.wkv6_train``: the kernels' forward
from a zero state, and a backward that recomputes the chunk through the
plain chunked form under autograd, which is the reference's own route (the
JAX package has no backward scan kernel and trains through XLA's autodiff
of ``_ssd_chunked`` and ``_wkv_chunked``).  Train mode returns no cache.
zamba2's ``mamba_attn`` trains its shared attention weights, passed in as
``shared`` by ``transformer``'s train forward.

Across ranks the three kinds take the train forward's ``mesh`` and ``par``
and run unchanged: ``runtime.steps.check_layout`` admits them under pure
FSDP or on a ``model`` axis of 1, where each rank scans its own batch rows
and every leaf comes to it whole (the shared attention gathered once a
microbatch with the top-level leaves).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssd_scan, ssd_scan_train
from repro_torch.kernels.wkv6 import wkv6, wkv6_train
from repro_torch.models.layers import compute_dtype, rms_norm
from repro_torch.models.params import PSpec


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return d_in, nheads, s.head_dim, s.state_dim, s.conv_kernel


def mamba_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D = cfg.d_model
    d_in, H, hd, N, K = _mamba_dims(cfg)
    return {
        "ln": PSpec((G, D), ("layers", None), "zeros"),
        "wz": PSpec((G, D, d_in), ("layers", "fsdp", "tp_inner")),
        "wx": PSpec((G, D, d_in), ("layers", "fsdp", "tp_inner")),
        "wB": PSpec((G, D, N), ("layers", "fsdp", None)),
        "wC": PSpec((G, D, N), ("layers", "fsdp", None)),
        "wdt": PSpec((G, D, H), ("layers", "fsdp", "tp_inner_heads")),
        "dt_bias": PSpec((G, H), ("layers", "tp_inner_heads"), "zeros"),
        "A_log": PSpec((G, H), ("layers", "tp_inner_heads"), "zeros"),
        "D_skip": PSpec((G, H), ("layers", "tp_inner_heads"), "ones"),
        "conv_w": PSpec((G, K, d_in), ("layers", "conv_k", "tp_inner"),
                        scale=0.5),
        "ln_y": PSpec((G, d_in), ("layers", "tp_inner"), "zeros"),
        "wout": PSpec((G, d_in, D), ("layers", "tp_inner", "fsdp")),
    }


def mamba_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    d_in, H, hd, N, K = _mamba_dims(cfg)
    return {
        "conv": PSpec((G, B, K - 1, d_in),
                      ("layers", "batch", None, "tp_inner"), "zeros"),
        "state": PSpec((G, B, H, hd, N),
                       ("layers", "batch", "tp_inner_heads", None, None),
                       "zeros", dtype="float32"),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x (B,S,C); w (K,C); cache (B,K-1,C) | None.
    Returns (out (B,S,C), the last K-1 inputs as the new cache)."""
    K, S = w.shape[0], x.shape[1]
    if cache is None:
        pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    out = 0
    for k in range(K):            # the reference's sum, in its order
        out = out + w[k] * xp[:, k:k + S]
    return out, xp[:, xp.shape[1] - (K - 1):]


def _silu_f32(x, cd):
    return F.silu(x.float()).to(cd)


def apply_mamba(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
                shared, extras=None, mesh=None, par=None):
    d_in, H, hd, N, K = _mamba_dims(cfg)
    cd = compute_dtype(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    z = h @ p["wz"].to(cd)
    xs = h @ p["wx"].to(cd)
    Bm = h @ p["wB"].to(cd)
    Cm = h @ p["wC"].to(cd)
    dt_raw = h @ p["wdt"].to(cd)
    dt_in = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros((), device=x.device))  # softplus
    a = -torch.exp(p["A_log"].float())

    new_cache = {}
    if mode == "decode":
        xs_c, conv_cache = _causal_conv(xs, p["conv_w"].to(cd), cache["conv"])
        xs_c = _silu_f32(xs_c, cd)
        xh = xs_c.reshape(*xs_c.shape[:2], H, hd)
        st = cache["state"].float()                     # (B,H,hd,N)
        da = torch.exp(dt[:, 0] * a)                    # (B,H)
        upd = torch.einsum("bh,bn,bhd->bhdn", dt[:, 0].float(),
                           Bm[:, 0].float(), xh[:, 0].float())
        st = da[..., None, None] * st + upd
        y = torch.einsum("bn,bhdn->bhd", Cm[:, 0].float(), st)
        y = y[:, None].to(cd)                           # (B,1,H,hd)
        cache["conv"].copy_(conv_cache)
        cache["state"].copy_(st)
        new_cache = cache
    else:
        xs_c, conv_cache = _causal_conv(xs, p["conv_w"].to(cd))
        xs_c = _silu_f32(xs_c, cd)
        xh = xs_c.reshape(*xs_c.shape[:2], H, hd)
        if mode == "train":
            y = ssd_scan_train(xh, dt, a, Bm, Cm, chunk=cfg.ssm.chunk)
        else:
            y, h_last = ssd_scan(xh, dt, a, Bm, Cm, chunk=cfg.ssm.chunk)
            new_cache = {"conv": conv_cache, "state": h_last}
        y = y.to(xh.dtype)
    y = y + p["D_skip"].to(cd)[None, None, :, None] * xh
    y = y.reshape(*y.shape[:2], d_in)
    y = rms_norm(y, p["ln_y"], cfg.norm_eps)
    y = y * _silu_f32(z, cd)
    return x + y @ p["wout"].to(cd), new_cache


# --- zamba2 hybrid: mamba + SHARED attention block (weights stored once) ---

def shared_attn_schema(cfg: ModelConfig):
    from repro_torch.models.transformer import _attn_mlp_schema
    s = _attn_mlp_schema(cfg, 1)
    return {k: PSpec(v.shape[1:], v.axes[1:], v.init, v.scale, v.dtype)
            for k, v in s.items()}


def mamba_attn_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    return mamba_schema(cfg, G)


def mamba_attn_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    from repro_torch.models.transformer import _attn_cache_schema
    out = dict(mamba_cache_schema(cfg, B, S, G))
    out["attn"] = _attn_cache_schema(cfg, B, S, G)
    return out


def apply_mamba_attn(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
                     shared, extras=None, mesh=None, par=None):
    """Mamba block followed by the *shared* attention block (zamba2)."""
    from repro_torch.models.transformer import attention_part, mlp_part
    mcache = None if cache is None else {k: cache[k] for k in ("conv", "state")}
    x, new_mcache = apply_mamba(cfg, p, x, mode=mode, positions=positions,
                                cache=mcache, pos=pos, shared=None)
    x, new_attn = attention_part(cfg, shared, x, window=None, mode=mode,
                                 positions=positions,
                                 cache=None if cache is None else cache["attn"],
                                 pos=pos)
    x = mlp_part(cfg, shared, x)
    new_cache = dict(new_mcache)
    if new_attn:
        new_cache["attn"] = new_attn
    return x, new_cache


# ===========================================================================
# RWKV6 (Finch): data-dependent per-channel decay
# ===========================================================================

def _rwkv_dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def rwkv_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, F_ = cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "ln1": PSpec((G, D), ("layers", None), "zeros"),
        "mu_r": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "mu_k": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "mu_v": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "mu_w": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "mu_g": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "wr": PSpec((G, D, D), ("layers", "fsdp", "tp_inner")),
        "wk": PSpec((G, D, D), ("layers", "fsdp", "tp_inner")),
        "wv": PSpec((G, D, D), ("layers", "fsdp", "tp_inner")),
        "wg": PSpec((G, D, D), ("layers", "fsdp", "tp_inner")),
        "w0": PSpec((G, D), ("layers", None), "zeros"),
        "wA": PSpec((G, D, lora), ("layers", "fsdp", None), scale=0.01),
        "wB": PSpec((G, lora, D), ("layers", None, "tp_inner"), scale=0.01),
        "u": PSpec((G, D), ("layers", None), "zeros"),
        "ln_x": PSpec((G, D), ("layers", None), "zeros"),
        "wout": PSpec((G, D, D), ("layers", "tp_inner", "fsdp")),
        # channel mix
        "ln2": PSpec((G, D), ("layers", None), "zeros"),
        "mu_ck": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "mu_cr": PSpec((G, D), ("layers", None), "ones", scale=0.5),
        "wk_c": PSpec((G, D, F_), ("layers", "fsdp", "tp_ff")),
        "wv_c": PSpec((G, F_, D), ("layers", "tp_ff", "fsdp")),
        "wr_c": PSpec((G, D, D), ("layers", "fsdp", "tp_inner")),
    }


def rwkv_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    H, hd = _rwkv_dims(cfg)
    return {
        "shift1": PSpec((G, B, 1, cfg.d_model), ("layers", "batch", None, None),
                        "zeros"),
        "shift2": PSpec((G, B, 1, cfg.d_model), ("layers", "batch", None, None),
                        "zeros"),
        "state": PSpec((G, B, H, hd, hd),
                       ("layers", "batch", "act_inner_heads", None, None),
                       "zeros", dtype="float32"),
    }


def _token_shift(x, prev):
    """x (B,S,D); prev (B,1,D) last token of the previous segment."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def apply_rwkv(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
               shared, extras=None, mesh=None, par=None):
    H, hd = _rwkv_dims(cfg)
    cd = compute_dtype(cfg)
    B, S, D = x.shape
    new_cache = {}

    # ---- time mix ----
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        hs = cache["shift1"].to(h.dtype)
    else:
        hs = _token_shift(h, torch.zeros((B, 1, D), dtype=h.dtype,
                                         device=h.device))

    def mix(mu):
        m = mu.to(cd)
        return h * m + hs * (1.0 - m)

    r = mix(p["mu_r"]) @ p["wr"].to(cd)
    k = mix(p["mu_k"]) @ p["wk"].to(cd)
    v = mix(p["mu_v"]) @ p["wv"].to(cd)
    g = mix(p["mu_g"]) @ p["wg"].to(cd)
    lora = torch.tanh(mix(p["mu_w"]) @ p["wA"].to(cd)) @ p["wB"].to(cd)
    logw = -torch.exp(p["w0"].float() + lora.float())     # (B,S,D) < 0
    logw = torch.clamp(logw, min=-8.0)                    # numerical floor

    rh, kh, vh, wh = (t.reshape(B, S, H, hd) for t in (r, k, v, logw))
    uh = p["u"].float().reshape(H, hd)

    if mode == "decode":
        st = cache["state"].float()                       # (B,H,hd,hd)
        rf, kf, vf = (t[:, 0].float() for t in (rh, kh, vh))
        kv = torch.einsum("bhi,bhj->bhij", kf, vf)
        y = torch.einsum("bhi,bhij->bhj", rf, st + uh[None, :, :, None] * kv)
        st = torch.exp(wh[:, 0].float())[..., None] * st + kv
        y = y[:, None]                                    # (B,1,H,hd)
        cache["shift1"].copy_(h)
        cache["state"].copy_(st)
        new_cache = cache
    elif mode == "train":
        y = wkv6_train(rh, kh, vh, wh, uh, chunk=cfg.rwkv.chunk)
    else:
        y, s_last = wkv6(rh, kh, vh, wh, uh, chunk=cfg.rwkv.chunk)
        new_cache = {"shift1": h[:, -1:], "state": s_last}
    y = y.reshape(B, S, D).to(cd)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps)
    y = y * _silu_f32(g, cd)
    x = x + y @ p["wout"].to(cd)

    # ---- channel mix ----
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "decode":
        hs2 = cache["shift2"].to(h2.dtype)
    else:
        hs2 = _token_shift(h2, torch.zeros((B, 1, D), dtype=h2.dtype,
                                           device=h2.device))

    def mix2(mu):
        m = mu.to(cd)
        return h2 * m + hs2 * (1.0 - m)

    kc = mix2(p["mu_ck"]) @ p["wk_c"].to(cd)
    kc = torch.square(torch.relu(kc.float())).to(cd)
    vc = kc @ p["wv_c"].to(cd)
    rc = torch.sigmoid((mix2(p["mu_cr"]) @ p["wr_c"].to(cd)).float()).to(cd)
    x = x + rc * vc
    if mode == "decode":
        cache["shift2"].copy_(h2)
    elif mode == "prefill":
        new_cache["shift2"] = h2[:, -1:]
    return x, new_cache

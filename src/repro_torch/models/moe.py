"""Top-k MoE block on one device: capacity-bounded dispatch, grouped matmul.

A port of the JAX package's ``models/moe.py``, single-rank path only (the
reference's ``ctx.mesh is None or tp == 1`` branch, which its serving
prefill and decode both take on one device):

  router (compute dtype) -> softmax in f32 -> top-k -> renormalise
  -> each (token, k) entry takes the next free row of its expert's bucket
     (E, cap_e, D), in (token, k) order, while the bucket has room
  -> gate, up and out products of every bucket through the port's grouped
     matmul (``kernels.moe_gmm``: the hand-written CUDA kernel on a CUDA
     tensor, its plain version on a CPU tensor), each given ``rows``, the
     count of every expert's kept entries (int32 (E,), on the device): the
     rows past it come out as zeros, and the weights of an expert no entry
     chose are not read (kimi's decode step fills at most 32 of 384)
  -> weighted combine in f32 over each token's K entries.

The capacities are the reference's: ``cap = int(ceil(T*K / tp) * cf)``
rows for the exchange (tp = 1 here) and ``cap_e = int(ceil(cap / E) * cf)``
rows a bucket.  An entry past its bucket's capacity is dropped and adds
nothing (the block's residual keeps the token: the Switch rule).

Deliberate difference from the reference: the JAX bucket scatter sends
every entry it does not keep (the padding rows of the exchange buffer,
present whenever cap > T*K, and the over-capacity entries) as a zero row to
``bucket[0, cap_e - 1]``, and that write lands after the real one, so
when expert 0 fills its bucket its last kept token loses its expert-0
term (ROADMAP queue C).  Here those entries go to a spare row that nothing
reads, and every kept entry computes.  Where no expert fills, the two
agree.

The shard_map / all_to_all expert-parallel paths of the reference are
multi-device work (ROADMAP queue A, item 12).  In train mode the three
products go through ``moe_gmm.gmm_train``, whose backward launches the same
kernel twice more (dx, dw); the index writes and gathers of the dispatch
are differentiable as they stand (the spare row takes the dropped entries'
grads, and nothing reads it), and the block hands the load-balance aux
loss to ``transformer``'s train forward, which adds it to the loss as the
reference does.  Serving calls ``gmm`` and drops the aux loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import gmm, gmm_train
from repro_torch.models.layers import compute_dtype, rms_norm
from repro_torch.models.params import PSpec


def moe_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": PSpec((G, D, E), ("layers", "fsdp", None), scale=0.02),
        "moe_wg": PSpec((G, E, D, Fd), ("layers", "expert", "fsdp", None)),
        "moe_wu": PSpec((G, E, D, Fd), ("layers", "expert", "fsdp", None)),
        "moe_wo": PSpec((G, E, Fd, D), ("layers", "expert", None, "fsdp")),
    }


def capacities(T: int, K: int, E: int, cf: float) -> tuple[int, int]:
    """(cap, cap_e) for T tokens of K entries on one rank, as the
    reference computes them (``moe.py:64,94`` with tp = 1)."""
    cap = int(T * K * cf)
    return cap, int(-(-cap // E) * cf)


def _dispatch(x2d, top_idx, *, E: int, cf: float, compute_dtype):
    """x2d (T, D); top_idx (T, K) -> (bucket (E, cap_e, D), row (TK,),
    kept (TK,), rows (E,) int32).

    Entry i = t*K + k is kept when i < cap (the exchange buffer) and fewer
    than cap_e earlier entries chose its expert.  Its bucket row is that
    count (a running sum of hits, so (token, k) order, as the reference's
    stable sort gives); dropped entries write to a spare row past the
    buckets.  ``rows[e]`` counts expert e's kept entries, which fill its
    rows 0 .. rows[e] - 1: the reference's ``min(counts_e, cap_e)``
    (``moe.py:95-98``, tp = 1).  It stays on the device (no host sync), and
    the grouped matmul reads only those rows and, where it is 0, none of
    the expert's weights.
    """
    T, D = x2d.shape
    K = top_idx.shape[-1]
    TK = T * K
    cap, cap_e = capacities(T, K, E, cf)
    flat_e = top_idx.reshape(TK).long()
    # (E, TK) hits, summed along the contiguous axis (a scan down the
    # other one runs one thread per expert on the card)
    hits = flat_e[None, :] == torch.arange(E, device=x2d.device)[:, None]
    seen = hits.cumsum(1, dtype=torch.int32)
    rank = seen.gather(0, flat_e[None, :])[0] - 1
    kept = rank < cap_e
    if cap < TK:
        kept &= torch.arange(TK, device=x2d.device) < cap
    # each expert's hits among the exchange's first min(cap, TK) entries,
    # at most cap_e of them kept
    n = min(cap, TK)
    rows = (seen[:, n - 1].clamp(max=cap_e) if n else
            torch.zeros(E, dtype=torch.int32, device=x2d.device))
    spare = E * cap_e
    row = torch.where(kept, flat_e * cap_e + rank, spare)      # (TK,)

    bucket = torch.zeros((spare + 1, D), dtype=compute_dtype,
                         device=x2d.device)
    bucket[row] = x2d.to(compute_dtype).repeat_interleave(K, dim=0)
    return bucket[:spare].view(E, cap_e, D), row, kept, rows


def _dispatch_compute_combine(x2d, top_idx, top_w, wg, wu, wo, *, E: int,
                              cf: float, compute_dtype, train: bool = False):
    """x2d (T, D); top_idx/top_w (T, K); wg/wu (E, D, F), wo (E, F, D).
    Returns (T, D) in ``compute_dtype``; ``train`` runs the products through
    ``gmm_train`` (the kernel's gradient).  The buckets are ``_dispatch``'s;
    the three products take its ``rows``, so the rows past them come out
    as zeros and empty experts' weights are not read.
    """
    T, D = x2d.shape
    K = top_idx.shape[-1]
    TK = T * K
    bucket, row, kept, rows = _dispatch(x2d, top_idx, E=E, cf=cf,
                                        compute_dtype=compute_dtype)
    spare = bucket.shape[0] * bucket.shape[1]

    mm = gmm_train if train else gmm
    gate = mm(bucket, wg.to(compute_dtype), rows)
    up = mm(bucket, wu.to(compute_dtype), rows)
    h = F.silu(gate.float()).to(compute_dtype) * up
    y = mm(h, wo.to(compute_dtype), rows).view(spare, D)

    # each token's K entries are rows t*K..t*K+K-1 of the flat order: a
    # gather and a sum over K in f32, as the reference's scatter-add (the
    # K terms in another order), and deterministic on the card, where a
    # scatter-add's atomics are not; a dropped entry reads some kept row
    # and weighs it 0
    w = torch.where(kept, top_w.reshape(TK).float(), 0.0)
    got = y[row.clamp(max=spare - 1)].float() * w[:, None]
    return got.view(T, K, D).sum(1).to(compute_dtype)


def _routed(cfg: ModelConfig, p, x, train: bool = False):
    """(routed MLP output (B,S,D), router probs (B,S,E) f32, top_idx)."""
    mcfg = cfg.moe
    E, K = mcfg.num_experts, mcfg.top_k
    cd = compute_dtype(cfg)
    B, S, D = x.shape
    logits = (x @ p["router"].to(cd)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    out = _dispatch_compute_combine(
        x.reshape(B * S, D), top_idx.reshape(B * S, K),
        top_w.reshape(B * S, K), p["moe_wg"], p["moe_wu"], p["moe_wo"],
        E=E, cf=mcfg.capacity_factor, compute_dtype=cd, train=train)
    return out.reshape(B, S, D), probs, top_idx


def moe_mlp(cfg: ModelConfig, p, x, train: bool = False):
    """x (B,S,D) -> (B,S,D), plus the load-balance aux loss (f32 scalar):
    ``aux_weight * E * sum_e f_e * p_e`` (Shazeer et al.), f_e the share of
    entries routed to e and p_e its mean router probability.  ``train``
    runs the expert products through ``gmm_train``."""
    E = cfg.moe.num_experts
    out, probs, top_idx = _routed(cfg, p, x, train)
    f = F.one_hot(top_idx, E).float().sum(2).mean(dim=(0, 1))
    pbar = probs.mean(dim=(0, 1))
    return out, cfg.moe.router_aux_weight * E * (f * pbar).sum()


def moe_block_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    from repro_torch.models.transformer import _attn_mlp_schema
    s = _attn_mlp_schema(cfg, G)
    del s["wg"], s["wu"], s["wo_mlp"]  # replaced by routed experts
    s.update(moe_schema(cfg, G))
    return s


def apply_moe_block(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
                    shared, extras=None):
    """Attention sub-block, then the routed MLP.  -> (x, new_cache); in
    train the second item is ``{"aux": the load-balance aux loss}``, which
    serving never computes."""
    from repro_torch.models.transformer import attention_part
    x, new_cache = attention_part(cfg, p, x, window=None, mode=mode,
                                  positions=positions, cache=cache, pos=pos)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "train":
        out, aux = moe_mlp(cfg, p, h, train=True)
        new_cache = {"aux": aux}
    else:
        out = _routed(cfg, p, h)[0]
    if cfg.post_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out, new_cache

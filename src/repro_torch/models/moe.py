"""Top-k MoE block: capacity-bounded dispatch, grouped matmul, and the
expert-parallel exchange across ranks.

A port of the JAX package's ``models/moe.py``.  On one rank (the
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

In training on a ``model`` axis of tp > 1 (``moe_mlp`` given a
``launch.mesh.RankMesh``, the reference's ``moe.py:45-185`` tp > 1 branch)
each rank owns E / tp experts: the sequence splits over ``model`` (under
sequence parallelism it arrives split), each
rank's entries fill a (tp, cap, D) send buffer by destination rank, an
``all_to_all`` carries them to their experts' ranks, which bucket them by
local expert and run the same grouped matmul on (E / tp, cap_e, D)
buckets, and the inverse ``all_to_all`` brings the results back for the
combine (``_exchange_compute_combine``).  The collectives and their
gradients are ``sharding.collectives``'.

The capacities are the reference's: ``cap = int(ceil(T*K / tp) * cf)``
rows a destination rank of the exchange and ``cap_e = int(ceil(tp * cap /
(E / tp)) * cf)`` rows a bucket (tp = 1 on one rank).  An entry past its
destination's or its bucket's capacity is dropped and adds nothing (the
block's residual keeps the token: the Switch rule).

Deliberate difference from the reference: the JAX scatters send every
entry they do not keep (the padding rows of the exchange buffer, present
whenever cap > T*K, and the over-capacity entries) as a zero row to the
last row of the buffer and to ``bucket[0, cap_e - 1]``, and that write
lands after the real one, so when expert 0 fills its bucket (or the last
destination its segment) a kept entry is lost (ROADMAP queue C).  Here
those entries go to a spare row that nothing reads, and every kept entry
computes.  Where nothing fills, the two agree.

In train mode the three products go through ``moe_gmm.gmm_train``, whose
backward launches the same kernel twice more (dx, dw); the index writes
and gathers of the dispatch are differentiable as they stand (the spare
row takes the dropped entries' grads, and nothing reads it), and the block
hands the load-balance aux loss to ``transformer``'s train forward, which
adds it to the loss as the reference does.  Serving calls ``gmm`` and
drops the aux loss; serving on a mesh (the reference's decode branch)
raises, ROADMAP queue A.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import gmm, gmm_train
from repro_torch.models.layers import (compute_dtype, rms_norm,
                                       sequence_parallel)
from repro_torch.models.params import PSpec
from repro_torch.sharding import collectives


def moe_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": PSpec((G, D, E), ("layers", "fsdp", None), scale=0.02),
        "moe_wg": PSpec((G, E, D, Fd), ("layers", "expert", "fsdp", None)),
        "moe_wu": PSpec((G, E, D, Fd), ("layers", "expert", "fsdp", None)),
        "moe_wo": PSpec((G, E, Fd, D), ("layers", "expert", None, "fsdp")),
    }


def capacities(T: int, K: int, E: int, cf: float,
               tp: int = 1) -> tuple[int, int]:
    """(cap, cap_e) for T tokens of K entries on one rank of a ``model``
    group of ``tp``: ``cap`` rows of the exchange buffer a destination
    rank, ``cap_e`` rows a bucket of its E / tp local experts, as the
    reference computes them (``moe.py:64,94``)."""
    cap = int(-(-(T * K) // tp) * cf)
    return cap, int(-(-(tp * cap) // (E // tp)) * cf)


def _bucket(x, ids, *, E: int, cap_e: int, compute_dtype):
    """x (N, D) rows, ids (N,) the bucket of each (E: none) -> (buckets
    (E, cap_e, D), row (N,), kept (N,), rows (E,) int32).

    Row i is kept when its bucket is a real one and fewer than cap_e
    earlier rows chose it.  Its bucket row is that count (a running sum
    of hits, so the rows' order, as the reference's stable sort gives);
    the rest write to a spare row past the buckets.  ``rows[e]`` counts
    bucket e's kept rows, which fill its rows 0 .. rows[e] - 1: the
    reference's ``min(counts_e, cap_e)`` (``moe.py:95-98``).  It stays on
    the device (no host sync).
    """
    N, D = x.shape
    # (E, N) hits, summed along the contiguous axis (a scan down the
    # other one runs one thread per bucket on the card)
    hits = ids[None, :] == torch.arange(E, device=x.device)[:, None]
    seen = hits.cumsum(1, dtype=torch.int32)
    rank = seen.gather(0, ids.clamp(max=E - 1)[None, :])[0] - 1
    kept = (rank < cap_e) & (ids < E)
    rows = (seen[:, -1].clamp(max=cap_e) if N else
            torch.zeros(E, dtype=torch.int32, device=x.device))
    spare = E * cap_e
    row = torch.where(kept, ids * cap_e + rank, spare)
    bucket = torch.zeros((spare + 1, D), dtype=compute_dtype,
                         device=x.device)
    bucket[row] = x.to(compute_dtype)
    return bucket[:spare].view(E, cap_e, D), row, kept, rows


def _dispatch(x2d, top_idx, *, E: int, cf: float, compute_dtype):
    """x2d (T, D); top_idx (T, K) -> (bucket (E, cap_e, D), row (TK,),
    kept (TK,), rows (E,) int32): ``_bucket`` of the flat (token, k)
    entries, of which the exchange buffer holds the first ``cap``.  The
    grouped matmul reads only each expert's ``rows`` and, where it is 0,
    none of the expert's weights.
    """
    T, D = x2d.shape
    K = top_idx.shape[-1]
    TK = T * K
    cap, cap_e = capacities(T, K, E, cf)
    ids = top_idx.reshape(TK).long()
    if cap < TK:
        ids = torch.where(torch.arange(TK, device=x2d.device) < cap, ids, E)
    return _bucket(x2d.to(compute_dtype).repeat_interleave(K, dim=0), ids,
                   E=E, cap_e=cap_e, compute_dtype=compute_dtype)


def _experts(bucket, rows, wg, wu, wo, *, compute_dtype, train: bool):
    """The gate, up and out products of every bucket -> (E * cap_e, D);
    each takes ``rows``, so the rows past them come out as zeros and empty
    experts' weights are not read."""
    E, C, D = bucket.shape
    mm = gmm_train if train else gmm
    gate = mm(bucket, wg.to(compute_dtype), rows)
    up = mm(bucket, wu.to(compute_dtype), rows)
    h = F.silu(gate.float()).to(compute_dtype) * up
    return mm(h, wo.to(compute_dtype), rows).view(E * C, D)


def _combine(y, row, kept, top_w, T: int, compute_dtype):
    """Each token's K entries from ``y`` rows ``row`` -> (T, D).

    The entries are rows t*K..t*K+K-1 of the flat order: a gather and a
    sum over K in f32, as the reference's scatter-add (the K terms in
    another order), and deterministic on the card, where a scatter-add's
    atomics are not; a dropped entry reads some kept row and weighs it 0.
    """
    K = top_w.shape[-1]
    w = torch.where(kept, top_w.reshape(T * K).float(), 0.0)
    got = y[row.clamp(max=y.shape[0] - 1)].float() * w[:, None]
    return got.view(T, K, -1).sum(1).to(compute_dtype)


def _dispatch_compute_combine(x2d, top_idx, top_w, wg, wu, wo, *, E: int,
                              cf: float, compute_dtype, train: bool = False):
    """x2d (T, D); top_idx/top_w (T, K); wg/wu (E, D, F), wo (E, F, D).
    Returns (T, D) in ``compute_dtype``; ``train`` runs the products through
    ``gmm_train`` (the kernel's gradient).  The buckets are ``_dispatch``'s.
    """
    bucket, row, kept, rows = _dispatch(x2d, top_idx, E=E, cf=cf,
                                        compute_dtype=compute_dtype)
    y = _experts(bucket, rows, wg, wu, wo, compute_dtype=compute_dtype,
                 train=train)
    return _combine(y, row, kept, top_w, x2d.shape[0], compute_dtype)


def _exchange_compute_combine(x2d, top_idx, top_w, wg, wu, wo, *, E: int,
                              cf: float, compute_dtype, train: bool, group):
    """The reference's tp > 1 branch on one rank of the ``model`` group
    ``group`` (``moe.py:45-130``): x2d (T, D) this rank's tokens,
    top_idx/top_w (T, K), wg/wu (E / tp, D, F) and wo (E / tp, F, D) its
    experts.  -> (T, D) in ``compute_dtype``.

    The flat (token, k) entries fill the (tp, cap, D) send buffer, each
    the next free row of its destination rank's segment while it has
    room (the stable sort by destination of the reference), with their
    local expert ids beside them; ``all_to_all`` carries the rows to the
    ranks that own their experts, which bucket them by local expert as
    ``_dispatch`` does one rank's (an empty send row has no expert), run
    the three products on (E / tp, cap_e, D) buckets with their ``rows``,
    write each result back to the row it came in on, and ``all_to_all``
    returns them.  The weighted combine is ``_combine``'s.  An entry past
    its destination's ``cap`` is dropped and writes to a spare row, not
    onto the last one of the buffer as the reference's does (the same
    deliberate difference as the buckets', ROADMAP queue C).
    """
    T, D = x2d.shape
    K = top_idx.shape[-1]
    tp = dist.get_world_size(group)
    E_local = E // tp
    cap, cap_e = capacities(T, K, E, cf, tp)
    flat_e = top_idx.reshape(T * K).long()
    send, slot, sent, _ = _bucket(
        x2d.to(compute_dtype).repeat_interleave(K, dim=0), flat_e // E_local,
        E=tp, cap_e=cap, compute_dtype=compute_dtype)
    send_e = torch.full((tp * cap + 1,), E_local, dtype=torch.int32,
                        device=x2d.device)
    send_e[slot] = (flat_e % E_local).to(torch.int32)
    recv = collectives.all_to_all(send, group).view(tp * cap, D)
    recv_e = collectives.all_to_all(send_e[:-1].view(tp, cap), group)
    bucket, row, kept, rows = _bucket(recv, recv_e.view(-1).long(),
                                      E=E_local, cap_e=cap_e,
                                      compute_dtype=compute_dtype)
    y = _experts(bucket, rows, wg, wu, wo, compute_dtype=compute_dtype,
                 train=train)
    back = torch.where(kept[:, None], y[row.clamp(max=y.shape[0] - 1)], 0)
    back = collectives.all_to_all(back.view(tp, cap, D), group)
    return _combine(back.view(tp * cap, D), slot, sent, top_w, T,
                    compute_dtype)


def _route(cfg: ModelConfig, p, x):
    """Router logits in the compute dtype -> (probs (B,S,E) f32, top_w,
    top_idx (B,S,K)), the top-k weights renormalised."""
    K = cfg.moe.top_k
    logits = (x @ p["router"].to(compute_dtype(cfg))).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_idx


def _routed(cfg: ModelConfig, p, x, train: bool = False):
    """(routed MLP output (B,S,D), router probs (B,S,E) f32, top_idx)."""
    mcfg = cfg.moe
    B, S, D = x.shape
    probs, top_w, top_idx = _route(cfg, p, x)
    out = _dispatch_compute_combine(
        x.reshape(B * S, D), top_idx.reshape(B * S, mcfg.top_k),
        top_w.reshape(B * S, mcfg.top_k), p["moe_wg"], p["moe_wu"],
        p["moe_wo"], E=mcfg.num_experts, cf=mcfg.capacity_factor,
        compute_dtype=compute_dtype(cfg), train=train)
    return out.reshape(B, S, D), probs, top_idx


def _routed_ep(cfg: ModelConfig, p, x, train: bool, mesh,
               sp: bool = False):
    """``_routed`` with this rank's experts on a ``model`` axis of tp > 1,
    each rank's sequence slice (the reference's ``P(dp_axes, "model",
    None)``) through ``_exchange_compute_combine``.  Under sequence
    parallelism (``sp``) ``x`` is that slice already: the router runs on
    it and the output stays on it.  Without, ``x`` is the rank's whole (B,
    S) block, which every ``model`` rank holds alike: the router runs on
    it, the sequence splits over ``model`` and the slices are gathered
    back."""
    mcfg = cfg.moe
    group = mesh.groups["model"]
    tp = mesh.size("model")
    B, S, D = x.shape
    if not sp and S % tp:
        raise NotImplementedError(
            f"the MoE block on a model axis of {tp} needs the sequence "
            f"({S}) to split over it; the reference's decode branch (S % tp "
            f"!= 0: every local expert on every token, then a psum, "
            f"moe.py:187-218) serves only serving on a mesh (ROADMAP "
            f"queue A)")
    probs, top_w, top_idx = _route(cfg, p, x)
    xs, ws, ids = (x, top_w, top_idx) if sp else (
        collectives.seq_split(t, 1, group) for t in (x, top_w, top_idx))
    s = xs.shape[1]
    out = _exchange_compute_combine(
        xs.reshape(B * s, D), ids.reshape(B * s, mcfg.top_k),
        ws.reshape(B * s, mcfg.top_k), p["moe_wg"], p["moe_wu"],
        p["moe_wo"], E=mcfg.num_experts, cf=mcfg.capacity_factor,
        compute_dtype=compute_dtype(cfg), train=train, group=group)
    out = out.view(B, s, D)
    if not sp:
        out = collectives.seq_gather(out, 1, group)
    return out, probs, top_idx


def moe_mlp(cfg: ModelConfig, p, x, train: bool = False, mesh=None,
            sp: bool = False):
    """x (B,S,D) -> (B,S,D), plus the load-balance aux loss (f32 scalar):
    ``aux_weight * E * sum_e f_e * p_e`` (Shazeer et al.), f_e the share of
    entries routed to e and p_e its mean router probability.  ``train``
    runs the expert products through ``gmm_train``.

    ``mesh`` (a ``launch.mesh.RankMesh``, the reference's ``ctx.mesh``)
    holds this rank's rows of the batch, ``p`` its experts: on a ``model``
    axis larger than 1 the tokens go to their experts' ranks
    (``_routed_ep``), and ``f`` and ``p`` are averaged over the ``data``
    group, the reference's means over the global batch.  On a ``model``
    axis of 1 each rank dispatches its own tokens, with the capacities of
    its T: the reference, under GSPMD, computes them over the global batch
    there, and the two agree wherever no bucket fills.  Under sequence
    parallelism (``sp``) ``x`` is this rank's sequence slice, and ``f`` and
    ``p`` are averaged over every rank, data and model: each holds an equal
    share of the tokens the reference's means run over.
    """
    E = cfg.moe.num_experts
    if mesh is not None and mesh.size("model") > 1:
        out, probs, top_idx = _routed_ep(cfg, p, x, train, mesh, sp)
    else:
        out, probs, top_idx = _routed(cfg, p, x, train)
    f = F.one_hot(top_idx, E).float().sum(2).mean(dim=(0, 1))
    pbar = probs.mean(dim=(0, 1))
    if sp:
        f = collectives.group_mean(f, mesh.world)
        pbar = collectives.group_mean(pbar, mesh.world)
    elif mesh is not None and mesh.size("data") > 1:
        f = collectives.group_mean(f, mesh.groups["data"])
        pbar = collectives.group_mean(pbar, mesh.groups["data"])
    return out, cfg.moe.router_aux_weight * E * (f * pbar).sum()


def moe_block_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    from repro_torch.models.transformer import _attn_mlp_schema
    s = _attn_mlp_schema(cfg, G)
    del s["wg"], s["wu"], s["wo_mlp"]  # replaced by routed experts
    s.update(moe_schema(cfg, G))
    return s


def apply_moe_block(cfg: ModelConfig, p, x, *, mode, positions, cache, pos,
                    shared, extras=None, mesh=None, par=None):
    """Attention sub-block, then the routed MLP.  -> (x, new_cache); in
    train the second item is ``{"aux": the load-balance aux loss}``, which
    serving never computes.  ``mesh`` (train only) is ``moe_mlp``'s; under
    sequence parallelism (``par``) the routed MLP takes the attention
    block's output slice as it stands."""
    from repro_torch.models.transformer import attention_part
    x, new_cache = attention_part(cfg, p, x, window=None, mode=mode,
                                  positions=positions, cache=cache, pos=pos,
                                  mesh=mesh, par=par)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "train":
        out, aux = moe_mlp(cfg, p, h, train=True, mesh=mesh,
                           sp=sequence_parallel(mesh, par))
        new_cache = {"aux": aux}
    else:
        out = _routed(cfg, p, h)[0]
    if cfg.post_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out, new_cache

"""Serving step functions and the KV cache layouts, in PyTorch.

Mirrors the prefill / decode half of the JAX package's
``runtime/steps.py`` without meshes or shardings:

  * ``prefill_step``  — B=1 prefill; unembeds only the last position;
  * ``slot_decode_step`` — one greedy step over all slots, each at its own
    position, against the slotted cache (layers, slots, S, KV, dh);
  * the paged pool (layers, num_blocks, block_size, KV, dh) addressed by
    per-slot block tables: ``paged_cache_view`` gathers a contiguous view,
    the decode forward runs on it unchanged, ``paged_cache_scatter`` writes
    back the one row each slot wrote.  Block 0 is the null block: table
    entries for unallocated positions point at it and out-of-range writes
    land on it; the decode mask turns its garbage into an exact 0.0
    contribution, which keeps paged decode bit-identical to slotted.

The JAX functions return new caches (their inputs are donated); these
write into the given cache or pool in place and return it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor):
    """tokens (B,S) -> (last-position logits (B,V), prompt-length caches)."""
    hidden, caches = tfm.forward(cfg, params, tokens, mode="prefill")
    last = tfm.lm_logits(cfg, params, hidden[:, -1:, :])[:, 0, :]
    return last, caches


def _greedy_decode(cfg: ModelConfig, params, caches, token, pos):
    hidden, caches = tfm.forward(cfg, params, token, mode="decode",
                                 caches=caches, pos=pos)
    logits = tfm.lm_logits(cfg, params, hidden)
    return logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None], caches


def slot_decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor,
                     pos: torch.Tensor):
    """One fused greedy step: token (B,1), pos (B,) -> (next (B,1), caches)."""
    return _greedy_decode(cfg, params, caches, token, pos)


# ---------------------------------------------------------------------------
# slotted cache: allocation + slot insert/evict (slot = index of axis 1)
# ---------------------------------------------------------------------------

def _zeros(schema, dtype: str, device):
    return pr.tree_map_schema(
        lambda _path, p: torch.zeros(p.shape, dtype=pr.torch_dtype(p.dtype or dtype),
                                     device=device), schema)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_cache(cfg: ModelConfig, B: int, S: int, device):
    """An all-zeros decode cache for B slots of S positions."""
    return _zeros(tfm.cache_schema(cfg, B, S), cfg.param_dtype, device)


def cache_batch_insert(dst, src, slot: int):
    """Copy a 1-slot cache ``src`` (sequence axis may be shorter) into slot
    ``slot`` of ``dst``; the tail stays as is, hidden by the decode mask."""
    def ins(d, s):
        d[:, slot:slot + 1, :s.shape[2]] = s.to(d.dtype)
        return d
    return _map(ins, dst, src)


def cache_batch_evict(dst, slot: int):
    """Zero one slot (hygiene; correctness never needs it)."""
    def ev(d):
        d[:, slot] = 0
        return d
    return _map(ev, dst)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def paged_compatible(cfg: ModelConfig, S: int, block_size: int) -> bool:
    """True iff every cache leaf is a (layers, batch, cache_seq, ...) KV
    layout whose sequence axis is S and divisible into blocks."""
    if block_size < 1 or S % block_size:
        return False
    flags = []
    pr.tree_map_schema(
        lambda _path, ps: flags.append(
            len(ps.axes) >= 3 and ps.axes[2] == "cache_seq"
            and ps.shape[2] == S),
        tfm.cache_schema(cfg, 1, S))
    return bool(flags) and all(flags)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device):
    """An all-zeros pool: leaves (layers, num_blocks, block_size, KV, dh)."""
    return _zeros(tfm.cache_schema(cfg, num_blocks, block_size),
                  cfg.param_dtype, device)


def paged_cache_view(pool, tables: torch.Tensor):
    """Gather each slot's blocks into a contiguous (layers, B, S, ...) view,
    value-identical to the slotted cache.  ``tables`` is (B, S // bs)."""
    def gather(leaf):
        g = leaf[:, tables]                       # (G, B, nb, bs, *tail)
        return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                         *g.shape[4:])
    return _map(gather, pool)


def paged_cache_scatter(pool, views, tables: torch.Tensor, pos: torch.Tensor):
    """Write back the one row per slot that the decode step wrote (slot i
    at ``pos[i]``).  Rows whose position is out of range land on the null
    block, where duplicate writes are harmless."""
    B = tables.shape[0]
    rows = torch.arange(B, device=tables.device)

    def scat(pleaf, vleaf):
        bs = pleaf.shape[2]
        S = vleaf.shape[2]
        at = pos.clamp(0, S - 1)
        vals = vleaf[:, rows, at]                 # (G, B, *tail)
        blk = tables[rows, (at // bs)]
        blk = torch.where(pos < S, blk, torch.zeros_like(blk))
        pleaf[:, blk, pos % bs] = vals.to(pleaf.dtype)
        return pleaf
    return _map(scat, pool, views)


def paged_prompt_insert(pool, src, blocks: torch.Tensor):
    """Splice a B=1 prefill cache (leaves (layers, 1, P, ...)) into the pool
    at the given (P // block_size,) distinct block ids."""
    def ins(pleaf, sleaf):
        bs = pleaf.shape[2]
        nb = sleaf.shape[2] // bs
        chunks = sleaf[:, 0].reshape(sleaf.shape[0], nb, bs, *sleaf.shape[3:])
        pleaf[:, blocks] = chunks.to(pleaf.dtype)
        return pleaf
    return _map(ins, pool, src)


def paged_decode_step(cfg: ModelConfig, params, pool, tables: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor):
    """One fused per-slot step against the pool: gather views -> the same
    decode forward -> scatter the written rows.  -> (next (B,1), pool)."""
    views = paged_cache_view(pool, tables)
    next_tok, views = _greedy_decode(cfg, params, views, token, pos)
    return next_tok, paged_cache_scatter(pool, views, tables, pos)

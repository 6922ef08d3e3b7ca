"""Continuous-batching serving engine (the device side), in PyTorch.

The ContinuousScheduler (scheduler.py) decides which requests occupy which
decode slots; this engine owns the params, the KV cache and the steps:

  * a B=1 prefill — each admitted request is prefilled alone (its
    attention runs the port's flash kernel on the card) and its
    prompt-length cache is spliced into its slot, or into its prompt
    blocks of the paged pool;
  * one fused per-slot decode step (runtime.steps) that advances all
    active slots one token per call, each at its own position;
  * the cache — the slotted layout (layers, slots, S, KV, dh) or, by
    default where the model allows it, a paged block pool addressed by
    per-slot block tables, refcounted by the host-side ``BlockPool``, with
    a radix-style prefix cache: a request sharing a cached prompt prefix
    skips re-prefilling the shared blocks and replays its suffix through
    the decode step.  Paged decode is bit-identical to slotted.

The lifecycle is the JAX engine's (``serving/engine.py``): admission,
prefill-and-insert, prefix replay, lazy block growth, preempt-youngest,
the release hook and ``run(queue)``.  Everything runs under
``torch.inference_mode()``; the cache is updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.metrics import Registry
from repro_torch.core.queue import WorkQueue
from repro_torch.device import resolve_device
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.runtime import steps as steps_mod
from repro_torch.serving.pool import BlockPool
from repro_torch.serving.report import GAUGES, record_serving_totals
from repro_torch.serving.scheduler import ContinuousScheduler, Slot


class ServingEngine:
    """Owns params, the cache and the step functions for one model.

    Parameters
    ----------
    cfg:
        Model config (dense attention kinds).
    device:
        ``"cuda"`` (default) or ``"cpu"``; ``"cuda"`` without a card raises.
    num_slots:
        Decode-slot pool size == batch dim of the fused decode step.
    prompt_len:
        Fixed prompt pad length (token id 1 pads; longer prompts truncate).
    max_new_tokens:
        Cache headroom per slot (requests asking for more are clamped).
    seed:
        Seeds the ``torch.Generator`` that draws params when none are given.
    params:
        Optional pre-initialised params (e.g. carried over by ``bridge``).
    paged:
        True forces the paged pool (raises if incompatible), False the
        slotted cache, None (default) picks paged whenever compatible.
    block_size:
        Tokens per KV block; must divide the prompt pad and cache length.
    pool_blocks:
        Total blocks incl. the null block; default fits every slot fully
        generated plus prefix-cache headroom.
    prefix_cache:
        Enable radix-style prefix reuse across requests (paged only).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", num_slots: int = 4,
                 prompt_len: int = 32, max_new_tokens: int = 16, seed: int = 0,
                 params=None, registry: Optional[Registry] = None,
                 clock=time.monotonic, paged: Optional[bool] = None,
                 block_size: int = 8, pool_blocks: Optional[int] = None,
                 prefix_cache: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_new_tokens = max_new_tokens
        self.metrics = registry if registry is not None else Registry()
        self.clock = clock
        self.prompt_pad = prompt_len
        self.cache_len = S = prompt_len + max_new_tokens

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = pr.init_params(tfm.lm_schema(cfg), gen, cfg.param_dtype,
                                    self.device)
        self.params = params

        compatible = (steps_mod.paged_compatible(cfg, self.cache_len,
                                                 block_size)
                      and self.prompt_pad % block_size == 0
                      and self.prompt_pad >= block_size)
        if paged and not compatible:
            raise ValueError(
                f"{cfg.family} cache cannot be paged with "
                f"block_size={block_size} (prompt_pad={self.prompt_pad}, "
                f"cache_len={self.cache_len})")
        self.paged = compatible if paged is None else bool(paged)
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache) and self.paged

        if self.paged:
            nb_total = self.cache_len // block_size
            nb_prompt = self.prompt_pad // block_size
            if pool_blocks is None:
                pool_blocks = 1 + num_slots * nb_total + 2 * nb_prompt
            if pool_blocks < 1 + nb_prompt + 1:
                raise ValueError(
                    f"pool_blocks={pool_blocks} cannot admit one request "
                    f"(needs {nb_prompt} prompt blocks + 1 gen + null)")
            self._nb_total = nb_total
            self._nb_prompt = nb_prompt
            self._pool = steps_mod.init_paged_cache(cfg, pool_blocks,
                                                    block_size, self.device)
            self._tables = np.zeros((num_slots, nb_total), np.int64)
            bytes_per_block = sum(
                leaf.numel() // pool_blocks * leaf.element_size()
                for leaf in steps_mod.tree_leaves(self._pool))
            self.block_pool = BlockPool(pool_blocks, block_size,
                                        bytes_per_block=bytes_per_block,
                                        registry=self.metrics)
            self._slot_meta = [None] * num_slots
            self._caches = None
        else:
            self.block_pool = None
            self._caches = steps_mod.init_cache(cfg, num_slots, S, self.device)

    # ------------------------------------------------------------ steps
    def _pad_prompt(self, prompt) -> np.ndarray:
        row = np.ones((1, self.prompt_pad), np.int64)
        toks = list(prompt)[:self.prompt_pad]
        row[0, :len(toks)] = toks
        return row

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    @torch.inference_mode()
    def prefill_into(self, slot_index: int, prompt) -> int:
        """Prefill one request alone and splice its cache into the slot
        (slotted) or its prompt blocks (paged).  Returns the first
        generated token."""
        t0 = self.clock()
        tokens = self._tensor(self._pad_prompt(prompt))
        last, small = steps_mod.prefill_step(self.cfg, self.params, tokens)
        if self.paged:
            blocks = self._tensor(self._tables[slot_index, :self._nb_prompt])
            steps_mod.paged_prompt_insert(self._pool, small, blocks)
        else:
            steps_mod.cache_batch_insert(self._caches, small, slot_index)
        first = int(last[0].argmax())
        self.metrics.gauge(GAUGES.PREFILL_S, self.clock() - t0)
        return first

    @torch.inference_mode()
    def decode_step(self, tokens, positions) -> np.ndarray:
        """One fused greedy step over all slots.  ``tokens``/``positions``
        are per-slot host lists; returns the new tokens."""
        tok = self._tensor(np.asarray(tokens, np.int64)[:, None])
        pos = self._tensor(np.asarray(positions, np.int64))
        if self.paged:
            out, self._pool = steps_mod.paged_decode_step(
                self.cfg, self.params, self._pool, self._tensor(self._tables),
                tok, pos)
        else:
            out, self._caches = steps_mod.slot_decode_step(
                self.cfg, self.params, self._caches, tok, pos)
        return out[:, 0].cpu().numpy()

    def warmup(self) -> None:
        """Run prefill and decode once off the clock (kernel build, CUDA
        context, allocator).  Paged warmup writes into blocks
        1..nb_prompt with all-null tables — content that is either
        overwritten by the block's first owner or masked."""
        if self.paged:
            self._tables[0, :self._nb_prompt] = np.arange(
                1, 1 + self._nb_prompt)
        self.prefill_into(0, [1] * self.prompt_pad)
        self.decode_step([0] * self.num_slots, [0] * self.num_slots)
        if self.paged:
            self._tables[0] = 0

    # ------------------------------------------------------- paged plumbing
    def _admit_paged(self, sched: ContinuousScheduler, slot: Slot) -> bool:
        """Allocate blocks for an admitted request: retain cached shared
        prefix blocks, alloc fresh ones for the rest of the prompt plus the
        first generation block.  On a prefix hit the suffix replays through
        the decode step.  Returns False (and nacks) when the pool cannot
        satisfy the admission."""
        row = self._pad_prompt(slot.request.prompt)[0].tolist()
        shared = []
        if self.prefix_cache:
            # one block short of the full prompt: the replay suffix is
            # never empty and shared blocks precede every write position
            shared = self.block_pool.match(
                row, max_blocks=self._nb_prompt - 1)
        fresh = self.block_pool.alloc(self._nb_prompt - len(shared) + 1)
        if fresh is None:
            self.block_pool.release(shared)
            sched.release_slot(slot)
            return False
        blocks = shared + fresh
        self._slot_meta[slot.index] = {
            "blocks": blocks, "n_prompt": self._nb_prompt, "prompt": row}
        trow = np.zeros(self._nb_total, np.int64)
        trow[:len(blocks)] = blocks
        self._tables[slot.index] = trow
        if shared:
            sched.start_replay(slot, row[len(shared) * self.block_size:],
                               len(shared) * self.block_size)
        else:
            first = self.prefill_into(slot.index, slot.request.prompt)
            sched.start(slot, first, self.prompt_pad)
        return True

    def _ensure_paged_capacity(self, sched: ContinuousScheduler) -> None:
        """Allocate each active slot's next generation block at a block
        boundary; under pool exhaustion preempt the youngest slot."""
        for slot in sorted(sched.active(), key=lambda s: s.admitted_at):
            if slot.free:
                continue
            bi = slot.pos // self.block_size
            if bi >= self._nb_total or self._tables[slot.index, bi] != 0:
                continue
            got = self.block_pool.alloc(1)
            while got is None:
                victims = [s for s in sched.active() if s is not slot]
                if not victims:
                    break
                sched.release_slot(max(victims, key=lambda s: s.admitted_at))
                got = self.block_pool.alloc(1)
            if got is None:
                sched.release_slot(slot)
                continue
            self._tables[slot.index, bi] = got[0]
            self._slot_meta[slot.index]["blocks"].append(got[0])

    def _on_slot_release(self, slot: Slot, reason: str) -> None:
        """Free the slot's blocks; a completed request's prompt blocks go
        into the prefix cache first."""
        meta = self._slot_meta[slot.index]
        if meta is None:
            return
        self._slot_meta[slot.index] = None
        if reason == "completed" and self.prefix_cache:
            self.block_pool.cache_prefix(meta["prompt"],
                                         meta["blocks"][:meta["n_prompt"]])
        self.block_pool.release(meta["blocks"])
        self._tables[slot.index] = 0

    # ----------------------------------------------------------- main loop
    def run(self, queue: WorkQueue, *, worker: str = "server",
            default_max_new: Optional[int] = None, idle_wait: float = 1e-3
            ) -> Tuple[Dict[Any, list], Registry]:
        """Serve the queue to exhaustion with continuous batching.

        Returns ``(results, metrics)``; ``results[rid]`` holds the
        generated tokens (length == the request's stop length).
        """
        cap = self.cache_len - self.prompt_pad
        sched = ContinuousScheduler(
            queue, self.num_slots, worker=worker, registry=self.metrics,
            clock=self.clock,
            default_max_new=min(default_max_new or self.max_new_tokens, cap))
        if self.paged:
            sched.on_release = self._on_slot_release
        t_start = self.clock()
        decode_s = 0.0
        while True:
            for slot in sched.admit():
                if slot.request.max_new_tokens > cap:
                    slot.request = dataclasses.replace(
                        slot.request, max_new_tokens=cap)
                if self.paged:
                    self._admit_paged(sched, slot)
                else:
                    first = self.prefill_into(slot.index, slot.request.prompt)
                    sched.start(slot, first, self.prompt_pad)
            if not sched.active():
                if sched.finished():
                    break
                time.sleep(idle_wait)
                continue
            if self.paged:
                self._ensure_paged_capacity(sched)
                if not sched.active():
                    continue
            t0 = self.clock()
            toks = self.decode_step(sched.last_tokens(), sched.positions())
            decode_s += self.clock() - t0
            sched.observe(toks)
            sched.renew_leases()
        wall = self.clock() - t_start
        results = sched.results()
        record_serving_totals(self.metrics, sched.useful_tokens, wall,
                              decode_s)
        return results, self.metrics

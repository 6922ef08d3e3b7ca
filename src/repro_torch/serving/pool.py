"""Host-side block-pool bookkeeping for the paged KV cache.

The device side (runtime.steps: ``init_paged_cache`` / ``paged_cache_view``
/ ``paged_cache_scatter``) is pure data movement; everything *policy* —
which block belongs to whom, when it can be reused — lives here, mirroring
the scheduler/engine split.

Blocks are refcounted.  Block 0 is reserved as the NULL block (table
entries for unallocated tail positions point at it; its garbage content is
masked to an exact 0.0 contribution by the decode attention mask, see
runtime/steps.py).  A radix-style prefix cache sits on top: completed
prompts register their block chain under content-derived chain keys
(``key_i = (key_{i-1}, chunk_i_tokens)`` — exact, no hash collisions), so
a later request sharing the prefix retains the cached blocks instead of
re-prefilling them.  Cached blocks at refcount 0 stay resident and
LRU-evictable; ``alloc`` reclaims them only under pressure, which is what
makes the cache free: it occupies only blocks nobody is using.

Shared blocks are never written: the engine block-aligns the shared
prefix and caps it below the padded prompt length, so every write position
of the new request lands in its own freshly allocated blocks — no
copy-on-write machinery needed.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import Registry
from repro_torch.serving.report import GAUGES


class BlockPool:
    """Free-list + refcount + prefix-cache bookkeeping for ``num_blocks``
    fixed-size blocks (block 0 reserved as the null block)."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 bytes_per_block: int = 0,
                 registry: Optional[Registry] = None):
        if num_blocks < 2:
            raise ValueError("need at least one non-null block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.bytes_per_block = bytes_per_block
        self.metrics = registry if registry is not None else Registry()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks
        # chain key -> cached block id, in LRU order (oldest first)
        self._lru: "OrderedDict[Tuple, int]" = OrderedDict()
        self._key_of: Dict[int, Tuple] = {}

    # ------------------------------------------------------------ accounting
    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (free list + evictable cached)."""
        evictable = sum(1 for b in self._key_of if self._ref[b] == 0)
        return len(self._free) + evictable

    @property
    def in_use(self) -> int:
        return sum(1 for b in range(1, self.num_blocks) if self._ref[b] > 0)

    def ref(self, block: int) -> int:
        return self._ref[block]

    def _gauge(self) -> None:
        self.metrics.gauge(GAUGES.BLOCKS_IN_USE, self.in_use)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks (refcount 1 each), evicting LRU cached
        refcount-0 blocks under pressure.  Returns None — allocating
        nothing — if the pool cannot satisfy the request; the caller
        preempts a slot or retries later."""
        if n == 0:
            return []
        if n > len(self._free):
            self._evict(n - len(self._free))
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self._gauge()
        return blocks

    def _evict(self, k: int) -> int:
        evicted = 0
        for key in list(self._lru.keys()):
            if evicted >= k:
                break
            b = self._lru[key]
            if self._ref[b] == 0:
                del self._lru[key]
                del self._key_of[b]
                self._free.append(b)
                evicted += 1
        return evicted

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block.  At refcount 0 an uncached block
        returns to the free list; a cached one stays resident (evictable)."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"block {b} released below refcount 0")
            self._ref[b] -= 1
            if self._ref[b] == 0 and b not in self._key_of:
                self._free.append(b)
        self._gauge()

    # ---------------------------------------------------------- prefix cache
    def _chain_keys(self, prompt: Sequence[int], n_chunks: int):
        key = None
        for j in range(n_chunks):
            chunk = tuple(prompt[j * self.block_size:(j + 1) * self.block_size])
            key = (key, chunk)
            yield key

    def match(self, prompt: Sequence[int], *,
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest cached block-aligned prefix of ``prompt`` (capped at
        ``max_blocks``).  Matched blocks are retained (+1 ref) for the
        caller — shared ownership, never written by the new request.
        Records hit/miss/bytes-saved gauges in block units."""
        n_chunks = len(prompt) // self.block_size
        if max_blocks is not None:
            n_chunks = min(n_chunks, max_blocks)
        blocks: List[int] = []
        for key in self._chain_keys(prompt, n_chunks):
            b = self._lru.get(key)
            if b is None:
                break
            self._ref[b] += 1
            self._lru.move_to_end(key)
            blocks.append(b)
        hits, misses = len(blocks), n_chunks - len(blocks)
        if hits:
            self.metrics.inc(GAUGES.PREFIX_HITS, hits)
            self.metrics.inc(GAUGES.PREFIX_BYTES_SAVED,
                             hits * self.bytes_per_block)
        if misses:
            self.metrics.inc(GAUGES.PREFIX_MISSES, misses)
        self._gauge()
        return blocks

    def cache_prefix(self, prompt: Sequence[int],
                     blocks: Sequence[int]) -> int:
        """Register a completed request's prompt blocks under their chain
        keys so later requests can ``match`` them.  A key already cached
        (by an earlier request with the same prefix) keeps its existing
        block; the chain continues regardless — keys are content-derived,
        not block-derived.  Returns the number of newly cached blocks."""
        added = 0
        for key, b in zip(self._chain_keys(prompt, len(blocks)), blocks):
            if key in self._lru:
                self._lru.move_to_end(key)
                continue
            if b in self._key_of:       # already cached under another chain
                continue
            self._lru[key] = b
            self._key_of[b] = key
            added += 1
        return added

    @property
    def cached_blocks(self) -> int:
        return len(self._key_of)

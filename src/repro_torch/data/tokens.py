"""Deterministic synthetic LM token pipeline (numpy, host side).

A copy of the JAX package's ``data/tokens.py`` ``TokenPipeline._host_batch``:
batch ``i`` is a pure function of (seed, i), tokens follow a Zipf-ish
marginal with first-order structure so the loss can fall, and the JAX
trainer and the port see identical batches from the same seed.  Batches
stay numpy arrays; the train step moves them onto its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _host_batch(self, index: int) -> dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # zipf-ish unigrams + first-order structure: x[t+1] ~ f(x[t])
        base = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        tok = (base + 7919 * np.roll(base, 1, axis=1)) % max(V - 2, 1) + 1
        tok = tok.astype(np.int32)
        return {"tokens": tok[:, :S], "labels": tok[:, 1:S + 1]}

    def batch(self, index: int) -> dict:
        """Batch ``index``: {"tokens", "labels"} (B, S) int32."""
        return self._host_batch(index)

    def chunk(self, start: int, device_steps: int) -> dict:
        """Batches ``start .. start+device_steps-1`` stacked (K, B, S): the
        input of ``runtime.steps.train_chunk``."""
        per = [self._host_batch(start + j) for j in range(device_steps)]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}

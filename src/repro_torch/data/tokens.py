"""Deterministic synthetic LM token pipeline (numpy, host side).

A copy of the JAX package's ``data/tokens.py`` ``TokenPipeline._host_batch``
and ``ChunkPrefetcher``: batch ``i`` is a pure function of (seed, i),
tokens follow a Zipf-ish marginal with first-order structure so the loss
can fall, and the JAX trainer and the port see identical batches from the
same seed.  Batches stay numpy arrays; the train step moves them onto its
device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional

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


class ChunkPrefetcher:
    """Double-buffered chunk feeder for the training segments.

    While chunk k runs on the device, a background thread builds the numpy
    chunk k+1 (``TokenPipeline.chunk``); the segment moves each one onto
    its device.  ``schedule`` is the ordered list of ``(start,
    device_steps)`` chunks the run will consume (tail chunks may be
    shorter); ``depth`` is the number of chunks built ahead.

    ``get()`` returns ``(start, batches)`` in schedule order, raises
    ``StopIteration`` past the end and re-raises a failure to build a chunk.
    Always ``close()`` (or use as a context manager) so a preempted segment
    does not leak the thread.
    """

    _END = object()

    def __init__(self, pipe: TokenPipeline, schedule, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(
            target=self._fill, args=(pipe, list(schedule)), daemon=True)
        self._thread.start()

    def _fill(self, pipe, schedule):
        for entry in schedule + [self._END]:
            try:
                item = entry if entry is self._END else \
                    (entry[0], pipe.chunk(entry[0], entry[1]))
            except Exception as e:      # surface in get(), don't hang it
                self._error = e
                item = self._END
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set() or item is self._END:
                return

    def get(self, timeout: float = 120.0):
        item = self._q.get(timeout=timeout)
        if item is self._END:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so a producer blocked on put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

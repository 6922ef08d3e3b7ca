"""Slot-based continuous-batching scheduler (host-side policy).

The paper's distributed-inference step feeds many short requests through a
Redis-style job queue onto GPU pods (§III, §V).  The static batcher served
them drain-then-refill: lease a batch, decode until the *longest* request
finishes, ack, repeat — every short request idles its decode slot while the
stragglers run.  This module removes that barrier.

The model is a fixed pool of ``num_slots`` decode slots backed by a slotted
KV/state cache (repro_torch.runtime.steps).  The scheduler owns all *policy* and
bookkeeping and never touches an accelerator:

  admission   ``admit()`` leases queued requests into free slots, FIFO.
  prefill     the engine prefills each admitted request alone and reports
              the first generated token via ``start()``.
  decode      the engine runs one fused step over all slots per iteration;
              ``observe()`` records each slot's new token, advances its
              position, and *evicts* any slot whose request just hit its
              stop length — the freed slot is refillable on the very next
              ``admit()``, no inter-request barrier.
  leases      ``renew_leases()`` heartbeats the WorkQueue's visibility
              timeout for long-running requests so a live server is never
              double-served, while a crashed one still requeues its work.

Determinism: every decision is a pure function of (queue contents, injected
clock, observed tokens), so the scheduler is unit-testable with a fake
clock and a fake engine — no devices, no wall time (tests/test_serving.py).

Metrics (repro_torch.core.metrics.Registry):
  serve/admitted          counter — requests admitted into slots
  serve/completed         counter — requests finished and acked
  serve/tokens_generated  counter — useful (acked) tokens recorded
  serve/stale_tokens      counter — tokens from stale-acked duplicates
  serve/decode_steps      counter — fused decode iterations
  serve/slot_occupancy    gauge   — active slots at each decode step
  serve/queue_depth       gauge   — pending backlog sampled at admit()
  serve/ttft_s            series  — per-request enqueue -> first token
  serve/service_ttft_s    series  — per-request admit -> first token
  serve/request_latency_s series  — per-request enqueue -> completion
  serve/lease_renewals    counter — successful lease heartbeats
  serve/lease_lost        counter — slots dropped on an expired lease
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import Registry
from repro_torch.core.queue import WorkQueue
from repro_torch.serving.report import GAUGES


@dataclass(frozen=True)
class Request:
    """One inference request as it rides through the queue."""
    rid: Any                      # caller-visible id (results key)
    prompt: Tuple[int, ...]       # token ids
    max_new_tokens: int = 16      # stop length, counting the prefill token

    @classmethod
    def from_item(cls, task_id: int, item: Any, *,
                  default_max_new: int = 16) -> "Request":
        """Adapt a queue item: a Request passes through, a dict with
        {"id", "prompt"[, "max_new_tokens"]} is wrapped."""
        if isinstance(item, Request):
            return item
        return cls(rid=item.get("id", task_id),
                   prompt=tuple(item["prompt"]),
                   max_new_tokens=int(item.get("max_new_tokens",
                                               default_max_new)))


@dataclass
class Slot:
    """One decode slot: cache row ``index`` plus its request bookkeeping."""
    index: int
    task_id: Optional[int] = None
    request: Optional[Request] = None
    pos: int = 0                      # cache position the next token writes
    tokens: List[int] = field(default_factory=list)
    replay: List[int] = field(default_factory=list)  # prompt suffix to feed
    enqueued_at: float = 0.0          # queue submission time (queue clock)
    admitted_at: float = 0.0          # lease time
    first_token_at: Optional[float] = None
    lease_renewed_at: float = 0.0

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def done(self) -> bool:
        return (self.request is not None and not self.replay
                and len(self.tokens) >= self.request.max_new_tokens)

    def clear(self) -> None:
        self.task_id = None
        self.request = None
        self.pos = 0
        self.tokens = []
        self.replay = []
        self.first_token_at = None


class ContinuousScheduler:
    """Admission / eviction / lease policy for a fixed pool of decode slots.

    Parameters
    ----------
    queue:
        The WorkQueue requests arrive on (the paper's Redis job queue).
    num_slots:
        Size of the decode-slot pool == batch dim of the slotted cache.
    worker:
        Lease owner name reported to the queue.
    registry:
        Metrics sink; a fresh Registry if omitted.
    clock:
        Monotonic-time source.  Inject a fake for deterministic tests.
    renew_fraction:
        Heartbeat leases once ``renew_fraction * queue.lease_timeout``
        has elapsed since the last renewal (0.5 => renew at half-life).
    default_max_new:
        Stop length for queue items that don't carry their own.
    """

    def __init__(self, queue: WorkQueue, num_slots: int, *,
                 worker: str = "server", registry: Optional[Registry] = None,
                 clock=time.monotonic, renew_fraction: float = 0.5,
                 default_max_new: int = 16):
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        self.queue = queue
        self.slots = [Slot(i) for i in range(num_slots)]
        self.worker = worker
        self.metrics = registry if registry is not None else Registry()
        self._clock = clock
        self._renew_after = queue.lease_timeout * renew_fraction
        self._default_max_new = default_max_new
        self._results: Dict[Any, List[int]] = {}
        self.useful_tokens = 0        # acked completions only
        self.stale_tokens = 0         # duplicated work (lease expired)
        # Optional hook fired with (slot, reason) just before a slot is
        # cleared; reason in {"completed", "lease_lost", "released"}.
        # The paged engine frees/caches the slot's KV blocks here without
        # the scheduler knowing anything about paging.
        self.on_release = None

    # ------------------------------------------------------------ admission
    def admit(self) -> List[Slot]:
        """Lease queued requests into free slots (FIFO).  Returns the newly
        filled slots; the engine must prefill each and call ``start()``."""
        filled = []
        for slot in self.slots:
            if not slot.free:
                continue
            got = self.queue.lease(self.worker)
            if got is None:
                break
            tid, item = got
            now = self._clock()
            slot.task_id = tid
            slot.request = Request.from_item(
                tid, item, default_max_new=self._default_max_new)
            slot.pos = 0
            slot.tokens = []
            slot.replay = []
            slot.enqueued_at = self.queue.enqueued_at(tid)
            slot.admitted_at = now
            slot.lease_renewed_at = now
            slot.first_token_at = None
            self.metrics.inc(GAUGES.ADMITTED)
            filled.append(slot)
        # backlog after admission — the autoscaler's primary signal
        self.metrics.gauge(GAUGES.QUEUE_DEPTH, self.queue.pending)
        return filled

    def start(self, slot: Slot, first_token: int, prompt_pos: int
              ) -> List[Tuple[Any, List[int]]]:
        """Record a finished prefill: the first generated token and the cache
        position it will be written at by the next decode step.  A request
        whose stop length is 1 completes here; returns completions."""
        slot.tokens.append(int(first_token))
        slot.pos = int(prompt_pos)
        slot.first_token_at = self._clock()
        # user-visible TTFT includes queue wait (enqueue -> first token);
        # admit -> first token stays visible as the service-time gauge.
        self.metrics.gauge(GAUGES.TTFT_S,
                           slot.first_token_at - slot.enqueued_at)
        self.metrics.gauge(GAUGES.SERVICE_TTFT_S,
                           slot.first_token_at - slot.admitted_at)
        return self._evict_finished([slot])

    def start_replay(self, slot: Slot, suffix: Sequence[int],
                     start_pos: int) -> None:
        """Prefix-cache hit path: the slot's shared prompt blocks are
        already in the pool, so instead of a full prefill the engine feeds
        the non-shared prompt *suffix* through the fused decode step, one
        token per iteration (chunked prefill).  The slot emits nothing
        until the replay drains; the step that consumes the last prompt
        token produces the request's first generated token."""
        if not suffix:
            raise ValueError("replay suffix must be non-empty")
        slot.replay = [int(t) for t in suffix]
        slot.pos = int(start_pos)

    # --------------------------------------------------------- decode step
    def active(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    @property
    def occupancy(self) -> int:
        return sum(1 for s in self.slots if not s.free)

    def positions(self) -> List[int]:
        """Per-slot cache write positions for the fused decode step (free
        slots report 0 — their writes land in a region the next prefill
        overwrites, and their tokens are never observed)."""
        return [s.pos for s in self.slots]

    def last_tokens(self) -> List[int]:
        """Per-slot next decode input: the head of a replaying slot's
        prompt suffix, else the last generated token (0 if free)."""
        out = []
        for s in self.slots:
            if s.free:
                out.append(0)
            elif s.replay:
                out.append(s.replay[0])
            else:
                out.append(s.tokens[-1] if s.tokens else 0)
        return out

    def observe(self, step_tokens: Sequence[int]
                ) -> List[Tuple[Any, List[int]]]:
        """Record one fused decode step.  ``step_tokens[i]`` is slot i's new
        token (entries for free slots are ignored).  Advances positions,
        evicts every slot that reached its stop length, acks the queue, and
        returns the completed ``(rid, tokens)`` pairs."""
        if len(step_tokens) != len(self.slots):
            raise ValueError(
                f"expected {len(self.slots)} tokens, got {len(step_tokens)}")
        self.metrics.gauge(GAUGES.SLOT_OCCUPANCY, self.occupancy)
        self.metrics.inc(GAUGES.DECODE_STEPS)
        stepped = []
        for slot, tok in zip(self.slots, step_tokens):
            if slot.free:
                continue
            if slot.replay:
                # chunked-prefill replay: the step consumed one prompt
                # token; its output is discarded unless the replay just
                # drained, in which case it is the first generated token.
                slot.replay.pop(0)
                slot.pos += 1
                if slot.replay:
                    continue
                slot.tokens.append(int(tok))
                now = self._clock()
                slot.first_token_at = now
                self.metrics.gauge(GAUGES.TTFT_S, now - slot.enqueued_at)
                self.metrics.gauge(GAUGES.SERVICE_TTFT_S,
                                   now - slot.admitted_at)
                stepped.append(slot)
                continue
            slot.tokens.append(int(tok))
            slot.pos += 1
            stepped.append(slot)
        return self._evict_finished(stepped)

    def _evict_finished(self, slots: Sequence[Slot]
                        ) -> List[Tuple[Any, List[int]]]:
        done = []
        now = self._clock()
        for slot in slots:
            if not slot.done:
                continue
            req = slot.request
            self._results[req.rid] = list(slot.tokens)
            if self.queue.ack(slot.task_id, self.worker):
                self.metrics.inc(GAUGES.COMPLETED)
                self.metrics.inc(GAUGES.TOKENS, len(slot.tokens))
                self.useful_tokens += len(slot.tokens)
            else:
                # lease expired mid-flight and the task was reclaimed;
                # at-least-once semantics: our result stands, but the
                # tokens are duplicated work — they must not count as
                # useful throughput (they'd inflate tok/s exactly when
                # the autoscaler is deciding off it).
                self.metrics.inc(GAUGES.STALE_ACK)
                self.metrics.inc(GAUGES.STALE_TOKENS, len(slot.tokens))
                self.stale_tokens += len(slot.tokens)
            self.metrics.gauge(GAUGES.LATENCY_S,
                               now - slot.enqueued_at)
            done.append((req.rid, list(slot.tokens)))
            self._release(slot, "completed")
        return done

    # -------------------------------------------------------------- leases
    def renew_leases(self) -> int:
        """Heartbeat the visibility timeout of every active slot that is
        past its renewal half-life.  A slot whose lease was already lost is
        dropped un-acked (the queue will re-serve the request).  Returns
        the number of successful renewals."""
        now = self._clock()
        renewed = 0
        for slot in self.slots:
            if slot.free or now - slot.lease_renewed_at < self._renew_after:
                continue
            if self.queue.renew(slot.task_id, self.worker):
                slot.lease_renewed_at = now
                self.metrics.inc(GAUGES.LEASE_RENEWALS)
                renewed += 1
            else:
                self.metrics.inc(GAUGES.LEASE_LOST)
                self._release(slot, "lease_lost")
        return renewed

    def _release(self, slot: Slot, reason: str) -> None:
        if self.on_release is not None:
            self.on_release(slot, reason)
        slot.clear()

    def release_slot(self, slot: Slot) -> bool:
        """Return a slot's request to the queue un-acked (nack) and free
        the slot — cooperative stop and pool-exhaustion preemption.  The
        request requeues immediately, so a replacement engine re-serves it
        after one decode step instead of one visibility timeout."""
        if slot.free:
            return False
        ok = self.queue.nack(slot.task_id, self.worker)
        self.metrics.inc(GAUGES.PREEMPTED)
        self._release(slot, "released")
        return ok

    def release_all(self) -> int:
        """Nack every in-flight slot (cooperative-stop teardown)."""
        n = 0
        for slot in self.slots:
            if not slot.free:
                self.release_slot(slot)
                n += 1
        return n

    # ------------------------------------------------------------- results
    def finished(self) -> bool:
        """True once every slot is free and the queue has fully drained."""
        return self.occupancy == 0 and self.queue.drained()

    def results(self) -> Dict[Any, List[int]]:
        return dict(self._results)

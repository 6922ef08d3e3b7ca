"""Rollout replay queue — trajectories from actors to the learner.

A copy of the JAX package's ``rl/replay.py`` (host-only), plus
``RolloutQueue.rewind``, which the port's learner calls when it resumes
from a checkpoint after a crash.

The distributed-RL data plane is two ``core.queue.WorkQueue`` leases
deep:

  * **tickets** (built by :func:`ticket_queue`): rollout *requests* the
    whole actor fleet leases from one shared queue.  A killed actor's
    in-flight tickets are nacked by its engine's stop path (or reclaimed
    at lease expiry) and picked up by the surviving actors — actor
    preemption loses zero trajectories by construction;
  * **trajectories** (:class:`RolloutQueue`): finished rollouts pushed
    by actors and drained in leased batches by the learner, with
    renewal heartbeats while a batch is being trained on.  A learner
    that dies stops renewing and its batch requeues one timeout later.

Every trajectory carries the ``policy_version`` the generating actor
held; the learner consumes through :meth:`RolloutQueue.take_fresh`,
which acks-and-drops (never trains on) rollouts staler than
``max_policy_lag`` versions, metering them separately — the bounded
staleness contract of the RLJob.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

from repro_torch.core.queue import WorkQueue


@dataclass(frozen=True)
class Trajectory:
    """One finished rollout.  JSON-able (snapshots ride in checkpoint
    manifests), so token streams are plain int lists."""
    ticket: Any                  # the ticket id this rollout answered
    prompt: Tuple[int, ...]
    tokens: Tuple[int, ...]      # generated (action) tokens
    reward: float
    policy_version: int          # weights the actor held when generating
    actor: str = ""

    def to_item(self) -> dict:
        # int() coercion: generated tokens may arrive as numpy scalars,
        # and items must stay JSON-able for checkpoint-manifest snapshots
        return {"ticket": self.ticket,
                "prompt": [int(t) for t in self.prompt],
                "tokens": [int(t) for t in self.tokens],
                "reward": float(self.reward),
                "policy_version": int(self.policy_version),
                "actor": self.actor}

    @classmethod
    def from_item(cls, d: dict) -> "Trajectory":
        return cls(ticket=d["ticket"], prompt=tuple(d["prompt"]),
                   tokens=tuple(d["tokens"]), reward=float(d["reward"]),
                   policy_version=int(d["policy_version"]),
                   actor=d.get("actor", ""))


def is_stale(policy_version: int, current_version: int,
             max_policy_lag: int) -> bool:
    """The staleness predicate: a rollout generated at ``policy_version``
    may train against learner weights at ``current_version`` iff the
    version gap is <= ``max_policy_lag``."""
    return current_version - policy_version > max_policy_lag


def split_stale(trajs, current_version: int, max_policy_lag: int):
    """Partition trajectories into (fresh, stale) against the bound."""
    fresh = [t for t in trajs
             if not is_stale(t.policy_version, current_version,
                             max_policy_lag)]
    stale = [t for t in trajs
             if is_stale(t.policy_version, current_version, max_policy_lag)]
    return fresh, stale


def ticket_queue(*, lease_timeout: float = 30.0, max_attempts: int = 10,
                 clock: Callable[[], float] = time.monotonic) -> WorkQueue:
    """The shared rollout-request queue the actor fleet serves from."""
    return WorkQueue(lease_timeout=lease_timeout, max_attempts=max_attempts,
                     clock=clock)


class RolloutQueue:
    """Lease-heartbeat trajectory buffer between the actor fleet and the
    learner, with the staleness filter and its accounting built in."""

    def __init__(self, *, lease_timeout: float = 30.0, max_attempts: int = 5,
                 registry=None, clock: Callable[[], float] = time.monotonic):
        self.q = WorkQueue(lease_timeout=lease_timeout,
                           max_attempts=max_attempts, clock=clock)
        self._clock = clock
        # actors push from their own threads while the learner may rewind
        self._lock = threading.Lock()
        self.metrics = registry
        self.pushed = 0
        self.stale_dropped = 0
        self.trained = 0
        self.lag_trained: List[int] = []   # version lag of every trained rollout

    # ---------------------------------------------------------------- actors
    def push(self, traj: Trajectory) -> int:
        with self._lock:
            tid = self.q.put(traj.to_item())
            self.pushed += 1
        if self.metrics is not None:
            self.metrics.inc("rl/rollouts_enqueued")
            self.metrics.inc("rl/rollout_tokens", len(traj.tokens))
        return tid

    # --------------------------------------------------------------- learner
    def take_fresh(self, n: int, *, worker: str, current_version: int,
                   max_policy_lag: int) -> List[Tuple[int, Trajectory]]:
        """Lease up to ``n`` trainable trajectories.

        Stale rollouts (version gap > ``max_policy_lag``) are acked and
        DROPPED — consumed so they never block the queue, but metered on
        ``rl/stale_dropped`` instead of ever reaching a gradient.
        Returns [(task_id, Trajectory)]; the caller acks via
        :meth:`ack_trained` after the optimizer step lands (at-least-once:
        a learner death before the ack requeues the batch)."""
        out: List[Tuple[int, Trajectory]] = []
        while len(out) < n:
            got = self.q.lease(worker)
            if got is None:
                break
            tid, item = got
            traj = Trajectory.from_item(item)
            if is_stale(traj.policy_version, current_version, max_policy_lag):
                self.q.ack(tid, worker)
                self.stale_dropped += 1
                if self.metrics is not None:
                    self.metrics.inc("rl/stale_dropped")
                continue
            out.append((tid, traj))
        return out

    def renew(self, held: List[Tuple[int, Trajectory]], *, worker: str):
        """Heartbeat the leases on a batch still being accumulated or
        trained on (a compile can outlive any fixed visibility timeout)."""
        for tid, _ in held:
            self.q.renew(tid, worker)

    def ack_trained(self, held: List[Tuple[int, Trajectory]], *,
                    worker: str, current_version: int):
        """Complete a trained-on batch and record its version lag."""
        for tid, traj in held:
            if self.q.ack(tid, worker):
                self.trained += 1
                lag = current_version - traj.policy_version
                self.lag_trained.append(lag)
                if self.metrics is not None:
                    self.metrics.inc("rl/trained_rollouts")
                    self.metrics.gauge("rl/policy_lag", lag)

    def release(self, held: List[Tuple[int, Trajectory]], *, worker: str):
        """Return an untrained batch early (learner preempted mid-drain)."""
        for tid, _ in held:
            self.q.nack(tid, worker)

    # --------------------------------------------------------------- inspect
    @property
    def pending(self) -> int:
        return self.q.pending

    def max_lag_trained(self) -> int:
        return max(self.lag_trained, default=0)

    # ------------------------------------------------------------ checkpoint
    def snapshot(self) -> dict:
        """Queue state + staleness accounting; rides in the learner's
        checkpoint ``extra`` so a preempted learner resumes with the
        rollout buffer (and its audit trail) intact."""
        return {"queue": self.q.snapshot(),
                "pushed": self.pushed,
                "stale_dropped": self.stale_dropped,
                "trained": self.trained,
                "lag_trained": list(self.lag_trained)}

    def restore(self, snap: dict, *,
                clock: Callable[[], float] = time.monotonic) -> None:
        """Rebuild in place from a snapshot (leases do not survive, so
        every in-flight trajectory returns to pending — at-least-once)."""
        self.q = WorkQueue.restore(snap["queue"], clock=clock)
        self.pushed = int(snap.get("pushed", 0))
        self.stale_dropped = int(snap.get("stale_dropped", 0))
        self.trained = int(snap.get("trained", 0))
        self.lag_trained = list(snap.get("lag_trained", ()))

    def rewind(self, snap: dict) -> None:
        """Roll the queue back to a checkpoint's snapshot after a learner
        crash, keeping what arrived since: the trajectories trained on in
        the lost steps return to pending (their updates died with the
        learner), and those pushed after the snapshot stay queued behind
        them with their enqueue times.  The JAX learner does not rewind,
        so its re-executed steps train on later rollouts and the lost
        steps' rollouts are never trained on (ROADMAP queue C)."""
        with self._lock:
            later = self.q.snapshot()
            self.restore(snap, clock=self._clock)
            first_new = snap["queue"]["next_id"]
            for tid, item, _attempts, _done, t0 in sorted(later["tasks"]):
                if tid >= first_new:
                    self.q.put(item, enqueued_at=t0)
                    self.pushed += 1

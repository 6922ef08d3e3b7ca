"""Lease-based fault-tolerant work queue — the Redis job queue of the paper.

CHASE-CI's download/inference steps pop work from a Redis queue; workers that
die simply stop acking and their work is re-queued.  Semantics reproduced:

  * at-least-once delivery: a leased task that is not acked within
    ``lease_timeout`` becomes leasable again (visibility timeout);
  * idempotent completion: double-acks and acks from stale workers are
    ignored;
  * dead-lettering: tasks failing ``max_attempts`` times park in ``dead``;
  * work stealing == straggler mitigation: fast workers keep leasing while
    slow ones hold only their current lease (no barrier per item).

The queue is transport-agnostic and in-process here (single-container run);
a production deployment backs the same API with Redis.  State is
snapshot/restorable so the RL learner's checkpoint can carry its rollout
queue.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class _Task:
    task_id: int
    item: Any
    attempts: int = 0
    worker: Optional[str] = None
    lease_expiry: float = 0.0
    done: bool = False
    enqueued_at: float = 0.0


class WorkQueue:
    def __init__(self, items=(), *, lease_timeout: float = 30.0,
                 max_attempts: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.lease_timeout = lease_timeout
        self.max_attempts = max_attempts
        self._tasks: Dict[int, _Task] = {}
        self._pending: List[int] = []
        self._leased: Dict[int, _Task] = {}
        self._next_id = 0
        self.dead: List[_Task] = []
        for it in items:
            self.put(it)

    # ------------------------------------------------------------------ api
    def put(self, item, *, enqueued_at: Optional[float] = None) -> int:
        """Enqueue an item.  ``enqueued_at`` preserves the original
        submission time when a router migrates a request between queues
        (TTFT must charge the full wait, not restart it)."""
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = _Task(
                tid, item,
                enqueued_at=self._clock() if enqueued_at is None
                else enqueued_at)
            self._pending.append(tid)
            return tid

    def enqueued_at(self, task_id: int) -> float:
        """Submission timestamp (queue clock) — survives lease/nack cycles,
        so queue wait is measurable from the *first* enqueue even after a
        preempted attempt requeues the task."""
        with self._lock:
            t = self._tasks.get(task_id)
            return t.enqueued_at if t is not None else 0.0

    def _reclaim_expired(self, now: float) -> None:
        # requeues the ORIGINAL _Task (never re-puts): attempts and
        # enqueued_at survive the implicit requeue, so queue-wait metrics
        # charge from the first enqueue even across worker crashes
        expired = [tid for tid, t in self._leased.items()
                   if t.lease_expiry <= now]
        for tid in expired:
            t = self._leased.pop(tid)
            t.worker = None
            if t.attempts >= self.max_attempts:
                self.dead.append(t)
            else:
                self._pending.append(tid)

    def lease(self, worker: str) -> Optional[Tuple[int, Any]]:
        """Pop one task; it must be acked within lease_timeout or it requeues."""
        now = self._clock()
        with self._lock:
            self._reclaim_expired(now)
            if not self._pending:
                return None
            tid = self._pending.pop(0)
            t = self._tasks[tid]
            t.worker = worker
            t.attempts += 1
            t.lease_expiry = now + self.lease_timeout
            self._leased[tid] = t
            return tid, t.item

    def ack(self, task_id: int, worker: str) -> bool:
        """Complete a task.  Idempotent; stale-worker acks are ignored."""
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None or t.done:
                return False
            if t.worker != worker:      # lease expired and someone else owns it
                return False
            t.done = True
            self._leased.pop(task_id, None)
            return True

    def renew(self, task_id: int, worker: str) -> bool:
        """Extend the lease on a task the worker is still making progress on.

        Long-running work (a decode loop holding a slot for thousands of
        steps) outlives any fixed visibility timeout; heartbeating renew()
        keeps the task from being reclaimed and double-served while the
        worker is alive, without giving up crash-recovery: a worker that
        dies stops renewing and the task requeues one timeout later.
        Returns False (and does not extend) if the lease already expired
        or was reclaimed by another worker — the caller must drop the task.
        """
        now = self._clock()
        with self._lock:
            t = self._leased.get(task_id)
            if t is None or t.worker != worker or t.lease_expiry <= now:
                return False
            t.lease_expiry = now + self.lease_timeout
            return True

    def nack(self, task_id: int, worker: str) -> bool:
        """Return a task early (worker noticed it cannot finish).

        Like lease-expiry reclaim, this requeues the same task object:
        ``enqueued_at`` (and the attempt count) are preserved, never
        reset to the nack time."""
        with self._lock:
            t = self._leased.get(task_id)
            if t is None or t.worker != worker:
                return False
            t.worker = None
            self._leased.pop(task_id)
            if t.attempts >= self.max_attempts:
                self.dead.append(t)
            else:
                self._pending.append(task_id)
            return True

    # ------------------------------------------------------------- inspect
    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def leased(self) -> int:
        with self._lock:
            now = self._clock()
            return sum(1 for t in self._leased.values() if t.lease_expiry > now)

    @property
    def completed(self) -> int:
        with self._lock:
            return sum(1 for t in self._tasks.values() if t.done)

    def leased_by(self, worker: str) -> int:
        """Live leases held by ``worker`` — chaos hooks kill a worker at
        a moment it provably holds work, tests then assert the requeue."""
        now = self._clock()
        with self._lock:
            return sum(1 for t in self._leased.values()
                       if t.worker == worker and t.lease_expiry > now)

    def drained(self) -> bool:
        with self._lock:
            now = self._clock()
            self._reclaim_expired(now)
            return not self._pending and not self._leased

    # ---------------------------------------------------------- checkpoint
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "next_id": self._next_id,
                "lease_timeout": self.lease_timeout,
                "max_attempts": self.max_attempts,
                "tasks": [(t.task_id, t.item, t.attempts, t.done,
                           t.enqueued_at)
                          for t in self._tasks.values()],
                "pending": list(self._pending),
                "dead": [t.task_id for t in self.dead],
            }

    @classmethod
    def restore(cls, snap: dict, *, clock=time.monotonic) -> "WorkQueue":
        q = cls(lease_timeout=snap["lease_timeout"],
                max_attempts=snap["max_attempts"], clock=clock)
        q._next_id = snap["next_id"]
        dead = set(snap["dead"])
        for tid, item, attempts, done, *rest in snap["tasks"]:
            t = _Task(tid, item, attempts=attempts, done=done,
                      enqueued_at=rest[0] if rest else 0.0)
            q._tasks[tid] = t
            if tid in dead:
                q.dead.append(t)
        # Leases do not survive restarts, but FIFO fairness must: replay
        # the snapshotted pending order first (it encodes requeues/nacks),
        # then append tasks that were leased at snapshot time in task-id
        # order.  Old snapshots without "pending" degrade to id order.
        snapped = snap.get("pending")
        order = list(snapped) if snapped is not None else []
        seen = set(order) | dead
        for tid, *_ in snap["tasks"]:
            if tid not in seen and not q._tasks[tid].done:
                order.append(tid)
        q._pending = [tid for tid in order if tid not in dead
                      and not q._tasks[tid].done]
        return q


def run_workers(queue: WorkQueue, fn: Callable[[Any], Any], n_workers: int,
                *, name: str = "worker") -> List[Any]:
    """Drain a queue with n threads (the Kubernetes Job with N pods pattern).

    Returns results in task order.  A worker exception nacks the task so a
    healthy worker retries it — the paper's pod-crash story.  If every
    attempt of some task failed (dead-lettered), raises with the last error
    so failures are not silent.
    """
    results: Dict[int, Any] = {}
    lock = threading.Lock()
    last_error: List[BaseException] = []

    def loop(wid: str):
        while True:
            got = queue.lease(wid)
            if got is None:
                if queue.drained():
                    return
                time.sleep(0.001)
                continue
            tid, item = got
            try:
                out = fn(item)
            except Exception as e:
                with lock:
                    last_error.append(e)
                queue.nack(tid, wid)
                continue
            if queue.ack(tid, wid):
                with lock:
                    results[tid] = out

    threads = [threading.Thread(target=loop, args=(f"{name}-{i}",))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if queue.dead:
        raise RuntimeError(
            f"{len(queue.dead)} task(s) dead-lettered; last error: "
            f"{last_error[-1]!r}") from (last_error[-1] if last_error else None)
    return [results[k] for k in sorted(results)]

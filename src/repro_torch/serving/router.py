"""Multi-replica serving: session-affine router + HPA-style autoscaler.

A copy of the JAX package's ``serving/router.py``; it drives the port's
``ServingEngine`` (or any object with its ``run`` signature).  One
difference: the fleet has a ``device`` (default ``"cuda"``, which raises
without a card) that the engine factory builds each replica on.

One continuous-batching engine saturates at ``num_slots`` concurrent
requests; internet-scale traffic needs N of them.  This module runs N
replicas in-process (each an engine thread draining its own WorkQueue),
routes incoming requests across them, and scales N between
``min_replicas``/``max_replicas`` off the same queue-depth and
latency-percentile gauges the engines already record — the serving-side
analogue of Kubernetes' HorizontalPodAutoscaler over the paper's
Redis-queue/GPU-pod fan-out.

Routing policy: session affinity first (an item's ``"session"`` key pins
it to the replica that served the session before — that replica's prefix
cache already holds the session's prompt blocks), least-loaded otherwise.

Scale-down is cooperative and loss-free: the retired replica's
``should_stop`` flips, its engine nacks in-flight slots on the next step
boundary (bounded by ONE decode step, not a visibility timeout), and the
router drains its queue back through ``submit`` — preserving each
request's original enqueue time so TTFT keeps charging the full wait.

Replica lifecycle events surface through ``on_scale(desired, observed,
reason)``.  ``capacity(desired) -> granted`` optionally bounds scale-up
(a fair-share claim); nothing in the port passes one yet.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.metrics import Registry
from repro_torch.core.queue import WorkQueue
from repro_torch.device import resolve_device
from repro_torch.serving.report import GAUGES, record_serving_totals


@dataclass
class Replica:
    """One engine behind the router: its queue, thread and stop flag."""
    name: str
    queue: WorkQueue
    stop: threading.Event = field(default_factory=threading.Event)
    thread: Optional[threading.Thread] = None
    engine: Any = None

    @property
    def load(self) -> int:
        return self.queue.pending + self.queue.leased


class ReplicaSet:
    """N live engine replicas + routing + loss-free scale up/down.

    ``engine_factory(name, registry, device)`` must return an object with
    ``run(queue, worker=..., should_stop=..., exit_on_drain=False)``
    returning ``(results, metrics)`` — a ServingEngine on ``device``, or a
    fake in tests.  All replicas share one Registry, so the serve gauges
    aggregate across the fleet.
    """

    def __init__(self, engine_factory: Callable[[str, Registry, Any], Any],
                 *, device="cuda", lease_timeout: float = 30.0,
                 registry: Optional[Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 affinity_key: str = "session",
                 on_scale: Optional[Callable[[int, int, str], None]] = None,
                 capacity: Optional[Callable[[int], int]] = None):
        self.engine_factory = engine_factory
        self.device = resolve_device(device)
        self.lease_timeout = lease_timeout
        self.metrics = registry if registry is not None else Registry()
        self.clock = clock
        self.affinity_key = affinity_key
        self.on_scale = on_scale
        # capacity(desired) -> granted: a fair-share adapter (e.g.
        # FairShareScheduler.resize_claim) that bounds scale-up by the
        # tenant's share; scale-down always proceeds and returns devices
        self.capacity = capacity
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._retired: List[Replica] = []
        self._affinity: Dict[Any, str] = {}
        self._results: Dict[Any, list] = {}
        self._next = 0
        self.scale_events: List[Tuple[float, int, int, str]] = []

    # ------------------------------------------------------------- replicas
    def observed(self) -> int:
        with self._lock:
            return len(self._replicas)

    def total_backlog(self) -> int:
        with self._lock:
            return sum(r.load for r in self._replicas)

    def _spawn(self) -> Replica:
        name = f"replica-{self._next}"
        self._next += 1
        rep = Replica(name, WorkQueue(lease_timeout=self.lease_timeout,
                                      clock=self.clock))

        def serve():
            engine = self.engine_factory(name, self.metrics, self.device)
            rep.engine = engine
            results, _ = engine.run(rep.queue, worker=name,
                                    should_stop=rep.stop.is_set,
                                    exit_on_drain=False)
            with self._lock:
                self._results.update(results)

        rep.thread = threading.Thread(target=serve, name=name, daemon=True)
        rep.thread.start()
        return rep

    def scale_to(self, n: int, reason: str = "manual") -> None:
        """Start or cooperatively retire replicas until ``observed == n``.
        Retiring drains the replica's queue back through the router with
        original enqueue times preserved."""
        n = max(0, n)
        if self.capacity is not None:
            n = min(n, max(0, self.capacity(n))) if n > 0 else n
        with self._lock:
            desired, observed = n, len(self._replicas)
        if desired == observed:
            return
        self.scale_events.append((self.clock(), observed, desired, reason))
        self.metrics.inc(GAUGES.SCALE_EVENTS)
        while self.observed() < desired:
            rep = self._spawn()
            with self._lock:
                self._replicas.append(rep)
        retired = []
        with self._lock:
            while len(self._replicas) > desired:
                retired.append(self._replicas.pop())   # youngest first
        for rep in retired:
            self._retire(rep)
        self.metrics.gauge(GAUGES.REPLICAS, self.observed())
        if self.on_scale is not None:
            self.on_scale(desired, self.observed(), reason)

    def _retire(self, rep: Replica) -> None:
        rep.stop.set()
        if rep.thread is not None:
            rep.thread.join()
        # the engine nacked its in-flight slots on the way out; everything
        # left in the queue re-routes to the survivors
        while True:
            got = rep.queue.lease("__drain__")
            if got is None:
                break
            tid, item = got
            t0 = rep.queue.enqueued_at(tid)
            rep.queue.ack(tid, "__drain__")
            if self.observed():
                self.submit(item, enqueued_at=t0)
        with self._lock:
            self._retired.append(rep)

    # --------------------------------------------------------------- routing
    def submit(self, item: Any, *,
               enqueued_at: Optional[float] = None) -> Optional[str]:
        """Route one request: session affinity first (the pinned replica's
        prefix cache is warm for this session), least-loaded otherwise.
        Returns the chosen replica name (None if no replicas are live)."""
        session = item.get(self.affinity_key) if isinstance(item, dict) \
            else None
        with self._lock:
            if not self._replicas:
                return None
            target = None
            if session is not None:
                pinned = self._affinity.get(session)
                target = next((r for r in self._replicas
                               if r.name == pinned), None)
            if target is None:
                target = min(self._replicas, key=lambda r: r.load)
            if session is not None:
                self._affinity[session] = target.name
            target.queue.put(item, enqueued_at=enqueued_at)
            return target.name

    # ------------------------------------------------------------- shutdown
    def stop_all(self) -> Dict[Any, list]:
        """Cooperatively stop every replica and return merged results."""
        self.scale_to(0, reason="shutdown")
        with self._lock:
            return dict(self._results)

    def completed(self) -> float:
        return self.metrics.series(GAUGES.COMPLETED).total


class Autoscaler:
    """HPA-style reconciler: desired replicas from queue backlog and the
    p99 service-TTFT gauge, clamped to [min_replicas, max_replicas].

    ``target_backlog`` is the per-replica queue depth the fleet should
    hold (the HPA's target metric value); breaching ``ttft_slo_s`` at p99
    forces a scale-up by one even when the backlog looks fine — latency
    is the user-facing signal, depth the leading one."""

    def __init__(self, rset: ReplicaSet, *, min_replicas: int = 1,
                 max_replicas: int = 4, target_backlog: float = 4.0,
                 ttft_slo_s: Optional[float] = None):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.rset = rset
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.target_backlog = target_backlog
        self.ttft_slo_s = ttft_slo_s

    def recommend(self) -> int:
        backlog = self.rset.total_backlog()
        want = max(1, math.ceil(backlog / self.target_backlog))
        if self.ttft_slo_s is not None:
            p99 = self.rset.metrics.series(
                GAUGES.SERVICE_TTFT_S).percentile(99)
            if p99 > self.ttft_slo_s:    # 0.0 (never recorded) never trips
                want = max(want, self.rset.observed() + 1)
        return min(max(want, self.min_replicas), self.max_replicas)

    def step(self, reason: str = "reconcile") -> Optional[Tuple[int, int]]:
        """One reconcile tick: returns (observed, desired) when it acted,
        None when the fleet is already at the recommendation."""
        desired = self.recommend()
        observed = self.rset.observed()
        if desired == observed:
            return None
        self.rset.scale_to(desired, reason=reason)
        return observed, desired


def serve_replicated(engine_factory, requests, *, device="cuda",
                     min_replicas: int = 1,
                     max_replicas: int = 2, target_backlog: float = 4.0,
                     ttft_slo_s: Optional[float] = None,
                     lease_timeout: float = 30.0,
                     registry: Optional[Registry] = None,
                     clock: Callable[[], float] = time.monotonic,
                     reconcile_interval: float = 0.02,
                     timeout_s: float = 600.0,
                     on_scale=None,
                     should_stop: Optional[Callable[[], bool]] = None,
                     capacity: Optional[Callable[[int], int]] = None):
    """Serve ``requests`` through an autoscaled replica fleet.

    Submits everything up front (the queue-depth signal the autoscaler
    feeds on IS the arrival burst), reconciles until every request has
    been served+acked exactly once, then retires the fleet.  Replicas run
    on ``device`` (``"cuda"`` by default; it raises without a card).
    Returns ``(results, metrics, scale_events)``.
    """
    metrics = registry if registry is not None else Registry()
    rset = ReplicaSet(engine_factory, device=device,
                      lease_timeout=lease_timeout,
                      registry=metrics, clock=clock, on_scale=on_scale,
                      capacity=capacity)
    rset.scale_to(min_replicas, reason="startup")
    scaler = Autoscaler(rset, min_replicas=min_replicas,
                        max_replicas=max_replicas,
                        target_backlog=target_backlog,
                        ttft_slo_s=ttft_slo_s)
    t_start = clock()
    n = 0
    for item in requests:
        rset.submit(item)
        n += 1
    while rset.completed() < n:
        if clock() - t_start > timeout_s:
            break
        if should_stop is not None and should_stop():
            break
        scaler.step()
        time.sleep(reconcile_interval)
    results = rset.stop_all()
    wall = clock() - t_start
    # fleet-level totals overwrite the per-engine records: useful tokens
    # are the acked-only counter aggregated across every replica
    record_serving_totals(metrics, int(metrics.series(GAUGES.TOKENS).total),
                          wall, 0.0)
    return results, metrics, list(rset.scale_events)

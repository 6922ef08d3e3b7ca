"""Near-real-time monitoring stream — the paper's "visualization across
the network ... in near real-time" facility (§I contribution 4, §VI).

A single in-process ``EventBus`` carries everything that happens on the
shared fabric as typed, timestamped events:

  * ``sched``    — tenant job queued / placed / preempted / requeued /
                   done / failed, capacity grants (the multi-tenant
                   scheduler, not yet ported);
  * ``pod``      — pod lifecycle transitions (orchestrator pod watchers);
  * ``node``     — node churn: fail / join (orchestrator churn watchers);
  * ``transfer`` — metered cross-site byte movements (fabric watchers);
  * ``metric``   — selected throughput gauges (Registry listeners);
  * ``step``     — workflow step placed / done / skipped / scatter;
  * ``branch``   — workflow-program branch lifecycle: one event per
                   scatter shard or repeat iteration (``of=<step>``,
                   ``branch=<index>``), from ``repro_torch.flow``;
  * ``workflow`` — workflow-level lifecycle (e.g. ``cancelled`` with the
                   count of steps that will not run).

Delivery is synchronous fan-out into per-subscriber bounded deques: a
publisher appends and signals, a subscriber drains with ``poll``.  Lag is
therefore bounded by the subscriber's own polling cadence, not by any
broker — and when a slow subscriber's queue overflows, the OLDEST events
drop and are counted (``Subscription.dropped``, ``monitor/dropped``), so
a dashboard degrades to "recent window" instead of stalling publishers —
the paper's near-real-time contract over a lossy window.

A copy of the JAX package's ``vcluster/monitor.py``; the port's
``api.Session`` builds one bus per cluster or fabric session.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence


@dataclass(frozen=True)
class Event:
    """One monitoring event: a kind, an origin, and a payload."""
    seq: int                    # bus-global, gap-free ordering
    ts: float                   # publish wall-clock time
    kind: str       # sched | pod | node | transfer | metric | step |
                    # branch | workflow
    source: str                 # site / component / tenant that emitted it
    data: Mapping[str, Any] = field(default_factory=dict)

    def brief(self) -> str:
        payload = " ".join(f"{k}={v}" for k, v in self.data.items())
        return f"{self.kind:>8} {self.source:<12} {payload}"


class Subscription:
    """One subscriber's bounded view of the stream."""

    def __init__(self, bus: "EventBus", maxlen: int):
        self._bus = bus
        self._maxlen = maxlen
        self._q: deque = deque()
        self._cond = threading.Condition()
        self.dropped = 0            # events lost to this subscriber's bound
        self.closed = False

    def _push(self, ev: Event) -> bool:
        """Deliver one event; returns True iff the bound forced a drop."""
        with self._cond:
            if self.closed:
                return False
            dropped = False
            if len(self._q) >= self._maxlen:
                self._q.popleft()          # oldest first: keep the window
                self.dropped += 1
                dropped = True
            self._q.append(ev)
            self._cond.notify_all()
            return dropped

    def poll(self, timeout: float = 0.0,
             max_events: Optional[int] = None) -> List[Event]:
        """Drain available events (oldest first).  With ``timeout`` > 0,
        block up to that long for at least one event."""
        with self._cond:
            if not self._q and timeout > 0:
                self._cond.wait(timeout)
            out: List[Event] = []
            while self._q and (max_events is None or len(out) < max_events):
                out.append(self._q.popleft())
            return out

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()
        self._bus._unsubscribe(self)


class EventBus:
    def __init__(self, metrics=None):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._subs: List[Subscription] = []
        self._seq = itertools.count()
        self.published = 0

    # --------------------------------------------------------------- pub/sub
    def subscribe(self, maxlen: int = 1024) -> Subscription:
        sub = Subscription(self, maxlen)
        with self._lock:
            self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, kind: str, source: str = "", **data) -> Event:
        ev = Event(seq=next(self._seq), ts=time.time(), kind=kind,
                   source=source, data=data)
        with self._lock:
            subs = list(self._subs)
            self.published += 1     # counted under the lock: publishers
            # race from many threads and received==published must hold
        # each _push reports its own drop so the metric stays exact even
        # when many publisher threads interleave (summing s.dropped
        # before/after here would double-count concurrent drops)
        new_drops = sum(1 for sub in subs if sub._push(ev))
        if self.metrics is not None:
            self.metrics.inc("monitor/published")
            if new_drops:
                self.metrics.inc("monitor/dropped", new_drops)
        return ev

    def stats(self) -> Dict[str, Any]:
        """Bus health snapshot: total published plus, per subscriber,
        its bound, current queue depth, and oldest-drop count — the
        counters a dashboard shows to prove the lossy-window contract
        (drops recorded, publishers never blocked)."""
        with self._lock:
            subs = list(self._subs)
        return {
            "published": self.published,
            "subscribers": [
                {"maxlen": s._maxlen, "queued": len(s._q),
                 "dropped": s.dropped}
                for s in subs
            ],
        }

    # ------------------------------------------------------------- watchers
    def attach_cluster(self, cluster, site: str = "") -> None:
        """Tap one orchestrator: node churn + pod lifecycle events."""
        name = site or getattr(cluster, "site", "local")

        def on_node(event, device):
            self.publish("node", source=name, event=event,
                         device=repr(device))

        def on_pod(event, pod):
            self.publish("pod", source=name, event=event,
                         pod=pod.ctx.pod_id, namespace=pod.ctx.namespace,
                         devices=len(pod.ctx.devices))

        cluster.add_watcher(on_node)
        cluster.add_pod_watcher(on_pod)

    def attach_fabric(self, fabric) -> None:
        """Tap a federation: every site's cluster + the transfer meter."""
        for site in fabric.sites.values():
            self.attach_cluster(site.cluster, site.name)

        def on_transfer(src, dst, nbytes, sim_s, tenant):
            self.publish("transfer", source=src, dst=dst, bytes=nbytes,
                         sim_s=round(sim_s, 4), tenant=tenant or "-")

        fabric.add_watcher(on_transfer)

    def attach_registry(self, registry,
                        prefixes: Sequence[str] = ("elastic/", "serve/",
                                                   "vcluster/")) -> None:
        """Stream matching throughput/SLO gauges as ``metric`` events."""
        prefixes = tuple(prefixes)

        def on_record(name, value, ts):
            if name.startswith(prefixes):
                self.publish("metric", source="registry", name=name,
                             value=round(float(value), 6))

        registry.add_listener(on_record)

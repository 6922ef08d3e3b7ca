"""The failure menu — scheduled chaos driven in sim-time.

The paper's measurements are taken *under a dynamic network*: nodes
drop, whole sites disappear, links brown out while the workflows run.
This module turns that into a declarative, validated schedule:

  * ``node-fail`` / ``node-join``   — single-node churn at a site
    (``Cluster.fail_node`` / ``join_node``);
  * ``site-kill`` / ``site-restore`` — whole-site loss
    (``Fabric.fail_site`` / ``restore_site``);
  * ``link-degrade`` / ``link-restore`` — bandwidth brown-out on one
    inter-site link (``Fabric.degrade_link`` / ``restore_link``).

A ``ChaosSchedule`` validates at construction that no two failures
overlap on the same site (or the same link) unless ``allow_overlap`` is
set — an un-survivable double-failure is almost always a schedule typo,
and the validation is itself a graded property (tests/test_scenarios).
``ChaosInjector.fire_due(sim_now)`` applies everything due exactly once,
so the driver can call it from any window boundary without bookkeeping.

A copy of the JAX package's ``scenarios/chaos.py``, over the port's
``Fabric``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

KINDS = ("node-fail", "node-join", "site-kill", "site-restore",
         "link-degrade", "link-restore")
# which kinds OPEN a failure window, and which kind CLOSES each
_OPENS = {"node-fail": "node-join", "site-kill": "site-restore",
          "link-degrade": "link-restore"}


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled infrastructure failure (or recovery) at sim-time
    ``at_s``.  ``site`` targets node/site kinds; ``link`` (a, b) plus
    ``gbps`` target link kinds."""
    at_s: float
    kind: str
    site: Optional[str] = None
    link: Optional[Tuple[str, str]] = None
    gbps: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.at_s < 0:
            raise ValueError("at_s must be >= 0")
        if self.kind.startswith(("node-", "site-")) and not self.site:
            raise ValueError(f"{self.kind} needs site=")
        if self.kind.startswith("link-") and not self.link:
            raise ValueError(f"{self.kind} needs link=(a, b)")
        if self.kind == "link-degrade" and (self.gbps is None or
                                            self.gbps <= 0):
            raise ValueError("link-degrade needs gbps= > 0")

    @property
    def target(self) -> Tuple[str, ...]:
        """The resource a failure window is tracked against."""
        if self.link is not None:
            return ("link",) + tuple(sorted(self.link))
        return ("site", self.site)


@dataclass(frozen=True)
class ChaosSchedule:
    """A validated, time-ordered failure schedule."""
    events: Tuple[ChaosEvent, ...]
    allow_overlap: bool = False

    def __init__(self, events, *, allow_overlap: bool = False):
        object.__setattr__(self, "events",
                           tuple(sorted(events, key=lambda e: e.at_s)))
        object.__setattr__(self, "allow_overlap", allow_overlap)
        self.validate()

    def validate(self) -> None:
        """Reject two overlapping failure windows on one target.  A
        window opens at a failure kind and closes at its paired recovery
        on the same target; a second failure inside an open window is an
        overlap (site-kill while a node-fail is outstanding, double
        brown-out of one link, ...)."""
        if self.allow_overlap:
            return
        open_kind: Dict[Tuple[str, ...], str] = {}
        for ev in self.events:
            tgt = ev.target
            if ev.kind in _OPENS:
                if tgt in open_kind:
                    raise ValueError(
                        f"overlapping failures on {tgt}: {ev.kind} at "
                        f"t={ev.at_s:g} while {open_kind[tgt]} is "
                        f"outstanding (pass allow_overlap=True to permit)")
                open_kind[tgt] = ev.kind
            else:
                opener = {v: k for k, v in _OPENS.items()}[ev.kind]
                if open_kind.get(tgt) == opener:
                    del open_kind[tgt]

    def due(self, sim_now: float) -> List[ChaosEvent]:
        return [e for e in self.events if e.at_s <= sim_now]


class ChaosInjector:
    """Applies a schedule against a live ``Fabric``, exactly once per
    event, in event order, from whatever thread asks."""

    def __init__(self, fabric, schedule: ChaosSchedule, *, bus=None):
        self.fabric = fabric
        self.schedule = schedule
        self.bus = bus
        self.fired: List[Dict[str, Any]] = []
        self._done: set = set()
        self._failed_nodes: Dict[str, List[Any]] = {}
        self._lock = threading.Lock()

    def fire_due(self, sim_now: float) -> List[Dict[str, Any]]:
        """Apply every not-yet-fired event with ``at_s <= sim_now``.
        Returns the records appended to ``fired`` (each carries the
        event plus ``applied`` and any skip ``reason``)."""
        out = []
        with self._lock:
            for i, ev in enumerate(self.schedule.events):
                if i in self._done or ev.at_s > sim_now:
                    continue
                self._done.add(i)
                rec = self._apply(ev)
                self.fired.append(rec)
                out.append(rec)
                if self.bus is not None:
                    self.bus.publish("chaos", source=ev.site or
                                     "->".join(ev.link), event=ev.kind,
                                     at_s=ev.at_s, applied=rec["applied"])
        return out

    def _apply(self, ev: ChaosEvent) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"at_s": ev.at_s, "kind": ev.kind,
                               "site": ev.site, "link": ev.link,
                               "applied": True}
        try:
            if ev.kind == "node-fail":
                cluster = self.fabric.sites[ev.site].cluster
                online = cluster.online_devices
                if not online:
                    rec.update(applied=False, reason="no online devices")
                    return rec
                dev = online[-1]
                cluster.fail_node(dev)
                self._failed_nodes.setdefault(ev.site, []).append(dev)
            elif ev.kind == "node-join":
                stack = self._failed_nodes.get(ev.site) or []
                if not stack:
                    rec.update(applied=False, reason="no failed node")
                    return rec
                self.fabric.sites[ev.site].cluster.join_node(stack.pop())
            elif ev.kind == "site-kill":
                self.fabric.fail_site(ev.site)
            elif ev.kind == "site-restore":
                self.fabric.restore_site(ev.site)
            elif ev.kind == "link-degrade":
                self.fabric.degrade_link(ev.link[0], ev.link[1],
                                         gbps=ev.gbps)
                rec["gbps"] = ev.gbps
            elif ev.kind == "link-restore":
                applied = self.fabric.restore_link(ev.link[0], ev.link[1])
                if not applied:
                    rec.update(applied=False, reason="link not degraded")
        except (KeyError, ValueError) as e:
            rec.update(applied=False, reason=str(e))
        return rec

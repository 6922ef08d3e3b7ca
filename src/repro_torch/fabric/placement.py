"""Locality-aware placement — move the bytes or move the job.

The paper's virtual-cluster management exists to answer one question per
workflow step: run the pods where the data already is, or pre-stage the
data to where the compute is free (§I, §IV).  The planner scores every
live site

    score(site) = est_transfer_s(missing input bytes -> site, best links)
                + queue_cost_s * queue_depth(site)

and places the step at the argmin.  If the chosen site already holds
every input replica the step is ``data-local`` (the job moved); otherwise
the planner ``pre-stage``s the missing keys over the links (batched per
source, metered) before the step runs.  When the *data home* — the site
that would have been free to run at — is down or full, the step records
a migration, which is how a site loss shows up in the Table-I report.

``data_blind=True`` is the strawman the paper warns about: round-robin
over live sites, ignoring where the bytes live.  The federated store's
pull-through reads keep it *correct*; the meters show what it costs
(the JAX package's ``benchmarks/run.py::bench_fabric_placement``).

A port of the JAX package's ``fabric/placement.py``, unchanged in logic.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fabric.federated import FederatedStore
from repro_torch.fabric.topology import Site


@dataclass(frozen=True)
class Placement:
    """One placement verdict, kept for the step report."""
    site: str
    mode: str                    # "data-local" | "pre-stage"
    bytes_to_move: int
    est_transfer_s: float
    scores: Dict[str, float] = field(default_factory=dict)
    migrated_from: Optional[str] = None   # data home that could not host

    @property
    def migrated(self) -> bool:
        return self.migrated_from is not None


class PlacementPlanner:
    def __init__(self, fed: FederatedStore, *, queue_cost_s: float = 0.05,
                 data_blind: bool = False, tenant: str = ""):
        """``tenant`` makes the planner multi-tenant-aware: staging moves
        are billed to the tenant's byte counters, and site scores include
        the backlog OTHER tenants' in-flight transfers queue on the links
        the staging would use — so one tenant's pre-staging cannot
        starve another tenant's routes (the multi-tenant scheduler)."""
        self.fed = fed
        self.fabric = fed.fabric
        self.queue_cost_s = queue_cost_s
        self.data_blind = data_blind
        self.tenant = tenant
        self._rr = 0                     # data-blind round-robin cursor
        # steps placed but not yet finished (reserve/release): inline
        # steps (pods=1, no cluster submission) are otherwise invisible
        # to queue_depth, so concurrent branches would all pile onto the
        # same tie-broken site
        self._inflight: Dict[str, int] = {}
        self._inflight_lock = threading.Lock()

    # ------------------------------------------------------------- in-flight
    def reserve(self, site: str) -> None:
        """Record a step placed at ``site`` but not yet finished."""
        with self._inflight_lock:
            self._inflight[site] = self._inflight.get(site, 0) + 1

    def release(self, site: str) -> None:
        with self._inflight_lock:
            n = self._inflight.get(site, 0) - 1
            if n > 0:
                self._inflight[site] = n
            else:
                self._inflight.pop(site, None)

    def load(self, site: Site) -> int:
        """Pending work at a site: cluster queue depth plus placed-but-
        unfinished steps this planner is tracking."""
        with self._inflight_lock:
            inflight = self._inflight.get(site.name, 0)
        return site.queue_depth() + inflight

    # -------------------------------------------------------------- scoring
    def expand(self, inputs: Sequence[str]) -> List[str]:
        """Dataset keys for a step; ``"prefix/*"`` globs every cataloged
        key under the prefix (e.g. a trained model's whole leaf tree)."""
        keys: List[str] = []
        for k in inputs:
            if k.endswith("/*"):
                keys.extend(self.fed.list(k[:-2]))
            else:
                keys.append(k)
        return keys

    def bytes_missing(self, keys: Sequence[str], site: str, *,
                      include_down: bool = False) -> Tuple[int, float]:
        """(missing bytes, est. simulated seconds to stage them at site),
        grouped by best source so each source pays one link latency —
        the same batching ``FederatedStore.replicate_many`` performs.
        ``include_down`` also counts replicas at dead sites (used to ask
        "where WOULD this step run were every site healthy").  A key that
        exists but is unreachable from ``site`` (no configured link)
        scores the site as infinitely expensive rather than crashing."""
        by_src: Dict[str, int] = {}
        unreachable = False
        for key in keys:
            reps = self.fed.where(key, up_only=not include_down)
            if not reps or site in reps:
                continue        # not produced yet, or already local
            src = self.fed.best_src(key, site, include_down=include_down)
            if src is None:
                unreachable = True
                continue
            by_src[src] = by_src.get(src, 0) + self.fed.nbytes(key)
        missing = sum(by_src.values())
        est_s = sum(self.fabric.transfer_s(src, site, n, transfers=1) +
                    self.fabric.link_backlog_s(
                        src, site, exclude_tenant=self.tenant or None)
                    for src, n in by_src.items())
        if unreachable:
            est_s = float("inf")
        return missing, est_s

    def score(self, keys: Sequence[str], site: Site) -> float:
        _, est_s = self.bytes_missing(keys, site.name)
        return est_s + self.queue_cost_s * self.load(site)

    # ------------------------------------------------------------ placement
    def candidates(self, devices: int = 0) -> List[Site]:
        """Live sites that can host the step.  A zero-capacity site (all
        nodes offline) is never a candidate, even for a device-less step:
        its cluster would drain any pod the moment it landed."""
        return [s for s in self.fabric.up_sites()
                if s.capacity >= max(devices, 1)]

    def place(self, inputs: Sequence[str] = (), *,
              devices: int = 0) -> Placement:
        """Choose the site for a step with the given input dataset keys."""
        keys = self.expand(inputs)
        cands = self.candidates(devices)
        if not cands:
            raise RuntimeError(
                f"no live site can host a step needing {devices} devices")
        sites = list(self.fabric.sites.values())
        stats = {s.name: self.bytes_missing(keys, s.name) for s in sites}
        scores = {s.name: stats[s.name][1] +
                  self.queue_cost_s * self.load(s) for s in sites}
        # the data home: where this step WOULD run were every site healthy
        # (dead sites' replicas count; ties broken toward raw device
        # count) — if the home cannot host it now, this placement is a
        # migration and the report says so
        ideal = {s.name: self.bytes_missing(keys, s.name,
                                            include_down=True)[1] +
                 self.queue_cost_s * s.queue_depth() for s in sites}
        home = min(sites, key=lambda s: (ideal[s.name],
                                         -len(s.cluster.devices), s.name))
        if self.data_blind:
            chosen = cands[self._rr % len(cands)]
            self._rr += 1
        else:
            chosen = min(cands, key=lambda s: (scores[s.name], -s.capacity,
                                               s.name))
        migrated_from = home.name if (home.name != chosen.name and
                                      home not in cands) else None
        missing, est_s = stats[chosen.name]
        return Placement(site=chosen.name,
                         mode="data-local" if missing == 0 else "pre-stage",
                         bytes_to_move=missing, est_transfer_s=est_s,
                         scores={s.name: scores[s.name] for s in cands},
                         migrated_from=migrated_from)

    def prestage(self, inputs: Sequence[str],
                 site: str) -> Tuple[int, float]:
        """Move a step's missing inputs to its site ahead of execution."""
        return self.fed.replicate_many(self.expand(inputs), site,
                                       tenant=self.tenant)

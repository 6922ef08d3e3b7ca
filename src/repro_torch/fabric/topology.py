"""Sites + links — the Pacific Research Platform as a modeled network.

The paper's infrastructure is not one cluster: it is ~30 GPU appliances
("FIONAs") at PRP member institutions, joined by 10-100 Gbps links, with
"virtual cluster management for data communication" deciding where data
and compute meet (§I, §IV).  This module models that federation:

  * a ``Site`` owns its own site-tagged ``Cluster`` (compute) and
    ``ObjectStore`` (its Ceph pool) — one appliance / campus;
  * a ``Link`` between two sites has configured bandwidth and latency;
    moving bytes across it *costs* simulated wall-time
    ``latency + bytes / bandwidth`` and is metered into the shared
    metrics ``Registry`` (``fabric/bytes_moved``, ``fabric/transfer_s``,
    per-link byte counters) — the §VI measure-everything discipline
    applied to the network;
  * ``Fabric`` is the topology: site registry, link table, the transfer
    cost model, whole-site failure (``fail_site`` drains the site's
    cluster and hides its replicas), and a cross-site ``submit`` that
    places a ``JobSpec`` on the least-loaded live site.

``time_scale`` maps simulated transfer seconds onto real sleeps so a
benchmark's wall-clock *is* its simulated makespan (``time_scale=1.0``),
while unit tests run with ``time_scale=0`` and only the meters move.

A port of the JAX package's ``fabric/topology.py``.  Site clusters the
fabric builds hold logical slots (``devices=list(range(n))``), so that
capacity and placement score as in JAX; their work computes on the
fabric's ``device`` (``"cuda"`` by default, raising without a card).  A
site built from a caller's ``Cluster(devices=[torch.device(...)])``
computes on that cluster's own device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import Cluster, Job, JobSpec
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Link:
    """A directed site-to-site network path with a bandwidth/latency model."""
    src: str
    dst: str
    gbps: float                 # bandwidth, gigabits per second
    latency_s: float = 0.0      # per-transfer setup latency (RTT-ish)

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9 / 8

    def transfer_s(self, nbytes: int, transfers: int = 1) -> float:
        """Simulated seconds to move ``nbytes`` in ``transfers`` batched
        round-trips — batching N keys into one transfer pays the latency
        once, which is why the federated store coalesces copies."""
        return transfers * self.latency_s + nbytes / self.bytes_per_s


@dataclass
class Site:
    """One PRP appliance: a named cluster + its local object store."""
    name: str
    cluster: Cluster
    store: ObjectStore
    labels: Dict[str, str] = field(default_factory=dict)
    up: bool = True

    @property
    def capacity(self) -> int:
        """Online devices — 0 while the whole site is down."""
        return len(self.cluster.online_devices) if self.up else 0

    def queue_depth(self) -> int:
        return self.cluster.queue_depth()


class Fabric:
    """The federation topology: N sites, bandwidth-modeled links, meters."""

    def __init__(self, metrics: Optional[Registry] = None, *,
                 time_scale: float = 0.0, device="cuda"):
        self.metrics = metrics or Registry()
        self.time_scale = time_scale
        self.device = resolve_device(device)     # where built sites compute
        self.sites: Dict[str, Site] = {}
        self._links: Dict[Tuple[str, str], Link] = {}
        # original Link per degraded direction, so a restore (explicit or
        # via restore_site) returns the configured bandwidth exactly
        self._degraded: Dict[Tuple[str, str], Link] = {}
        self._lock = threading.Lock()
        # in-flight bytes per (link, tenant) — the backlog a tenant-aware
        # placement scorer reads so one tenant's pre-staging cannot
        # silently starve another tenant's links (``repro_torch.vcluster``)
        self._inflight: Dict[Tuple[str, str], Dict[str, int]] = {}
        # transfer watchers: cb(src, dst, nbytes, sim_s, tenant) after
        # every metered cross-site move (feeds the monitor event bus)
        self._watchers: List[Callable[[str, str, int, float, str],
                                      None]] = []

    # ------------------------------------------------------------- topology
    def add_site(self, name: str, *, devices: Optional[List[Any]] = None,
                 cluster: Optional[Cluster] = None,
                 store: Optional[ObjectStore] = None,
                 store_root: Optional[str] = None, **labels) -> Site:
        """Register a site.  Pass an existing cluster/store or let the
        fabric build them (``devices`` list, ``store_root`` dir); every
        site cluster shares the fabric's metrics registry.  A built
        cluster's ``devices`` are logical slots that compute on the
        fabric's device."""
        if name in self.sites:
            raise ValueError(f"site {name!r} exists")
        if cluster is None:
            cluster = Cluster(devices=list(devices if devices is not None
                                           else range(1)),
                              metrics=self.metrics, site=name,
                              compute=self.device)
        else:
            cluster.site = name
            # adopt the cluster onto the federation's registry so every
            # site meters into ONE scrape surface (per-tenant device-
            # lease billing, pod counters) — otherwise a user-provided
            # cluster's numbers are stranded in its private registry
            cluster.metrics = self.metrics
        if store is None:
            if store_root is None:
                import tempfile
                store_root = tempfile.mkdtemp(prefix=f"fabric-{name}-")
            store = ObjectStore(store_root)
        site = Site(name, cluster, store, labels)
        self.sites[name] = site
        return site

    def connect(self, a: str, b: str, *, gbps: float,
                latency_ms: float = 0.0, symmetric: bool = True) -> None:
        for name in (a, b):
            if name not in self.sites:
                raise ValueError(f"unknown site {name!r}")
        self._links[(a, b)] = Link(a, b, gbps, latency_ms / 1e3)
        if symmetric:
            self._links[(b, a)] = Link(b, a, gbps, latency_ms / 1e3)

    def degrade_link(self, a: str, b: str, *, gbps: float,
                     latency_ms: Optional[float] = None,
                     symmetric: bool = True) -> None:
        """Brown-out a link: replace its bandwidth (and optionally its
        latency) while remembering the configured original, so
        ``restore_link`` / ``restore_site`` can undo it exactly.  The
        degraded cost model is live immediately — placement scoring and
        every subsequent ``transfer`` see the reduced gbps.  Repeated
        degradations keep the FIRST original (a double brown-out still
        restores to the configured link)."""
        if gbps <= 0:
            raise ValueError(f"degraded gbps must be > 0, got {gbps}")
        pairs = [(a, b), (b, a)] if symmetric else [(a, b)]
        with self._lock:
            for key in pairs:
                link = self._links.get(key)
                if link is None:
                    raise ValueError(f"no link {key[0]!r} -> {key[1]!r}")
                self._degraded.setdefault(key, link)
                self._links[key] = dataclasses.replace(
                    link, gbps=gbps,
                    latency_s=link.latency_s if latency_ms is None
                    else latency_ms / 1e3)
        self.metrics.inc("fabric/link_degradations")
        self.metrics.inc(f"fabric/link/{a}->{b}/degradations")

    def restore_link(self, a: str, b: str, *, symmetric: bool = True) -> bool:
        """Return a degraded link to its configured bandwidth/latency.
        Returns False when the link was not degraded."""
        restored = False
        pairs = [(a, b), (b, a)] if symmetric else [(a, b)]
        with self._lock:
            for key in pairs:
                orig = self._degraded.pop(key, None)
                if orig is not None:
                    self._links[key] = orig
                    restored = True
        if restored:
            self.metrics.inc("fabric/link_restores")
        return restored

    def degraded_links(self) -> List[Tuple[str, str]]:
        """The directions currently running below configured bandwidth."""
        with self._lock:
            return sorted(self._degraded)

    def link(self, src: str, dst: str) -> Optional[Link]:
        """The link src->dst; None for a same-site (free) move."""
        if src == dst:
            return None
        try:
            return self._links[(src, dst)]
        except KeyError:
            raise ValueError(f"no link {src!r} -> {dst!r}") from None

    def up_sites(self) -> List[Site]:
        return [s for s in self.sites.values() if s.up]

    # ------------------------------------------------------------ transfers
    def transfer_s(self, src: str, dst: str, nbytes: int,
                   transfers: int = 1) -> float:
        link = self.link(src, dst)
        return 0.0 if link is None else link.transfer_s(nbytes, transfers)

    def add_watcher(self, cb: Callable[[str, str, int, float, str],
                                       None]) -> None:
        """Register cb(src, dst, nbytes, sim_s, tenant) per transfer."""
        self._watchers.append(cb)

    @contextmanager
    def reserve(self, src: str, dst: str, nbytes: int, tenant: str = ""):
        """Mark bytes as in flight on a link for the block's duration —
        the backlog other tenants' placement scoring sees.  ``transfer``
        wraps its sleep in this; tests can use it directly to simulate a
        long-running competing transfer."""
        key = (src, dst)
        with self._lock:
            q = self._inflight.setdefault(key, {})
            q[tenant] = q.get(tenant, 0) + nbytes
        try:
            yield
        finally:
            with self._lock:
                q = self._inflight.get(key, {})
                left = q.get(tenant, 0) - nbytes
                if left > 0:
                    q[tenant] = left
                else:
                    q.pop(tenant, None)
                if not q:
                    self._inflight.pop(key, None)

    def link_backlog_s(self, src: str, dst: str, *,
                       exclude_tenant: Optional[str] = None) -> float:
        """Simulated seconds of OTHER tenants' in-flight bytes queued on
        src->dst — the fair-share penalty a tenant-aware planner adds so
        one tenant's pre-staging cannot starve another's links.  0 for
        same-site or unconfigured routes."""
        if src == dst:
            return 0.0
        try:
            link = self.link(src, dst)
        except ValueError:
            return 0.0
        with self._lock:
            q = self._inflight.get((src, dst), {})
            pending = sum(b for t, b in q.items()
                          if exclude_tenant is None or t != exclude_tenant)
        return pending / link.bytes_per_s

    def transfer(self, src: str, dst: str, nbytes: int, *,
                 transfers: int = 1, tenant: str = "") -> float:
        """Account (and, scaled, *spend*) the cost of moving bytes.

        Returns the simulated seconds.  Same-site moves are free and
        unmetered; cross-site moves bump ``fabric/bytes_moved`` /
        ``fabric/transfer_s`` plus per-link byte counters, then sleep
        ``sim_s * time_scale`` so makespans reflect the network.  A
        ``tenant`` tag additionally meters the tenant's own byte counter
        and registers the bytes as link backlog while they move."""
        sim_s = self.transfer_s(src, dst, nbytes, transfers)
        if src == dst:
            return 0.0
        self.metrics.inc("fabric/bytes_moved", nbytes)
        self.metrics.inc("fabric/transfer_s", sim_s)
        self.metrics.inc("fabric/transfers", transfers)
        self.metrics.inc(f"fabric/link/{src}->{dst}/bytes", nbytes)
        if tenant:
            self.metrics.inc(f"fabric/tenant/{tenant}/bytes_moved", nbytes)
        if sim_s > 0 and self.time_scale > 0:
            with self.reserve(src, dst, nbytes, tenant):
                time.sleep(sim_s * self.time_scale)
        for cb in list(self._watchers):
            try:
                cb(src, dst, nbytes, sim_s, tenant)
            except Exception:   # observers must not break the data plane
                pass
        return sim_s

    # ---------------------------------------------------------- site churn
    def fail_site(self, name: str) -> None:
        """A whole appliance unplugs: its cluster drains every pod, its
        replicas stop being readable, and placement must route around it."""
        site = self.sites[name]
        site.up = False
        site.cluster.fail_all_nodes()
        self.metrics.inc("fabric/site_failures")

    def restore_site(self, name: str) -> None:
        """Bring an appliance back: nodes rejoin AND any degraded link
        touching the site returns to its configured bandwidth (a site
        restore is a power-cycle — its NICs come back clean)."""
        site = self.sites[name]
        site.up = True
        for d in list(site.cluster.devices):
            site.cluster.join_node(d)
        for src, dst in self.degraded_links():
            if name in (src, dst):
                self.restore_link(src, dst, symmetric=False)

    # ------------------------------------------------------------- compute
    def submit(self, namespace: str, spec: JobSpec, *,
               site: Optional[str] = None) -> Tuple[Site, Job]:
        """Cross-site submit: run a Job on ``site``, or on the live site
        with the most free headroom (capacity minus queue depth).  Data
        placement belongs to the planner (repro_torch.fabric.placement);
        this is the compute-only path for site-agnostic jobs."""
        if site is not None:
            cands = [self.sites[site]]
            if not cands[0].up:
                raise RuntimeError(f"site {site!r} is down")
        else:
            need = spec.devices_per_pod * spec.replicas
            cands = [s for s in self.up_sites() if s.capacity >= need]
            if not cands:
                raise RuntimeError(
                    f"no live site has {need} devices for {spec.name!r}")
            cands.sort(key=lambda s: (s.queue_depth() - s.capacity, s.name))
        chosen = cands[0]
        if namespace not in chosen.cluster.namespaces:
            chosen.cluster.create_namespace(namespace)
        return chosen, chosen.cluster.submit(namespace, spec)

"""FederatedStore — one content-addressed namespace over per-site stores.

The paper's Ceph is *distributed*: every pod sees one namespace, but the
bytes live somewhere, and moving them across the PRP costs real link
time.  This module keeps that honest:

  * a catalog maps ``key -> {site: nbytes}`` — the single namespace with
    per-site replicas; ``exists``/``list`` answer over every *live*
    replica (a dead site's unreplicated keys vanish until it returns);
  * ``replicate(key, dst)`` is an explicit, metered transfer over the
    best live link; concurrent replications of the same (key, dst) are
    deduped against an in-flight table (one copy moves, everyone waits);
  * ``replicate_many`` batches keys by source site so N small objects
    pay one link latency, not N;
  * ``SiteStore`` is the ObjectStore-compatible view a pod at one site
    holds: reads of non-local keys pull them across the link (metered
    pull-through cache — this is exactly what data-blind placement pays),
    writes land locally and register in the catalog, and an optional
    ``mirror`` site synchronously replicates matching prefixes (how
    elastic training keeps its checkpoints alive across a site loss).

A port of the JAX package's ``fabric/federated.py``: the catalog, the
transfers and the meters are the reference's, over the port's
``BlobCodecs``.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.data.objectstore import BlobCodecs
from repro_torch.fabric.topology import Fabric


def _under(key: str, prefix: str) -> bool:
    """Path-aware prefix match, mirroring ObjectStore.list semantics."""
    if not prefix:
        return True
    p = prefix.rstrip("/")
    if prefix.endswith("/"):
        return key.startswith(p + "/")
    return key == p or key.startswith(p + "/")


class FederatedStore:
    def __init__(self, fabric: Fabric):
        self.fabric = fabric
        self.metrics = fabric.metrics
        self._lock = threading.Lock()
        self._catalog: Dict[str, Dict[str, int]] = {}
        self._inflight: Dict[Tuple[str, str], threading.Event] = {}

    # -------------------------------------------------------------- catalog
    def register(self, key: str, site: str, nbytes: int) -> None:
        with self._lock:
            self._catalog.setdefault(key, {})[site] = nbytes

    def where(self, key: str, *, up_only: bool = True) -> List[str]:
        """Sites holding a replica (live sites only, by default)."""
        with self._lock:
            sites = list(self._catalog.get(key, ()))
        if up_only:
            sites = [s for s in sites if self.fabric.sites[s].up]
        return sorted(sites)

    def exists(self, key: str) -> bool:
        return bool(self.where(key))

    def nbytes(self, key: str) -> int:
        with self._lock:
            reps = self._catalog.get(key)
            return next(iter(reps.values())) if reps else 0

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            keys = list(self._catalog)
        return sorted(k for k in keys if _under(k, prefix) and self.where(k))

    def total_bytes(self, prefix: str = "") -> int:
        return sum(self.nbytes(k) for k in self.list(prefix))

    # ------------------------------------------------------------------ io
    def put(self, key: str, data: bytes, site: str,
            replicate_to: Sequence[str] = ()) -> None:
        # a write to a dead site would "succeed" into a black hole (its
        # replicas are unreadable until restore) — fail it loudly instead
        self._require_up(site)
        self.fabric.sites[site].store.put(key, data)
        self.register(key, site, len(data))
        for dst in replicate_to:
            self.replicate(key, dst)

    def get(self, key: str, site: Optional[str] = None) -> bytes:
        """Read a key.  With ``site``, the read happens *at* that site:
        a missing local replica is first pulled over the link (metered).
        Without a site this is an unmetered control-plane read (workflow
        markers/manifests — negligible bytes by design)."""
        if site is not None:
            self.replicate(key, site)
            return self.fabric.sites[site].store.get(key)
        reps = self.where(key)
        if not reps:
            raise FileNotFoundError(key)
        return self.fabric.sites[reps[0]].store.get(key)

    def delete(self, key: str) -> bool:
        """Drop every live replica + the catalog entry (single namespace:
        delete means *gone*, e.g. checkpoint GC must free every mirror)."""
        with self._lock:
            reps = self._catalog.pop(key, {})
        found = False
        for s in reps:
            if self.fabric.sites[s].up:
                found |= self.fabric.sites[s].store.delete(key)
        return found

    # ----------------------------------------------------------- replication
    def best_src(self, key: str, dst: str, *,
                 include_down: bool = False) -> Optional[str]:
        """The replica site the bytes should come FROM for a copy to
        ``dst``: ``dst`` itself if it already holds one, else the source
        with the fastest link.  None when no (reachable) replica exists —
        sites without a configured link are unreachable, not an error,
        so partial topologies score as expensive rather than crash."""
        reps = self.where(key, up_only=not include_down)
        if dst in reps:
            return dst
        best, best_bw = None, -1.0
        for src in reps:
            try:
                link = self.fabric.link(src, dst)
            except ValueError:
                continue                       # no route src -> dst
            bw = link.bytes_per_s if link else float("inf")
            if (bw, src) > (best_bw, best or ""):
                best, best_bw = src, bw
        return best

    def _best_src(self, key: str, dst: str) -> str:
        src = self.best_src(key, dst)
        if src is None:
            raise FileNotFoundError(
                f"no reachable live replica of {key!r} for {dst!r}")
        return src

    def _require_up(self, site: str) -> None:
        if not self.fabric.sites[site].up:
            raise RuntimeError(f"site {site!r} is down")

    def replicate(self, key: str, dst: str, *, tenant: str = "") -> float:
        """Copy ``key`` to ``dst`` (no-op if already there).  Returns the
        simulated transfer seconds.  In-flight copies of the same
        (key, dst) are deduped: the second caller waits on the first
        transfer instead of moving the bytes twice.  ``tenant`` tags the
        link accounting (the mover's tenant is billed; deduped waiters
        pay nothing)."""
        self._require_up(dst)
        while True:
            with self._lock:
                reps = self._catalog.get(key, {})
                if dst in reps:
                    return 0.0
                ev = self._inflight.get((key, dst))
                if ev is None:
                    ev = threading.Event()
                    self._inflight[(key, dst)] = ev
                    mine = True
                else:
                    mine = False
            if not mine:
                self.metrics.inc("fabric/replicate_dedup")
                ev.wait(timeout=60.0)
                continue   # re-check: the owner may have failed
            try:
                src = self._best_src(key, dst)
                data = self.fabric.sites[src].store.get(key)
                sim_s = self.fabric.transfer(src, dst, len(data),
                                             tenant=tenant)
                self.fabric.sites[dst].store.put(key, data)
                self.register(key, dst, len(data))
                return sim_s
            finally:
                with self._lock:
                    self._inflight.pop((key, dst), None)
                ev.set()

    def replicate_many(self, keys: Iterable[str], dst: str, *,
                       tenant: str = "") -> Tuple[int, float]:
        """Pre-stage a set of keys at ``dst``, batched by source site so
        each (src, dst) pair pays ONE link latency for the whole group.
        Unknown/unreachable keys are skipped (outputs yet to be produced,
        or stranded behind a dead link) and counted in
        ``fabric/missing_key``.  Returns (bytes_moved, sim_seconds)."""
        self._require_up(dst)
        by_src: Dict[str, List[str]] = {}
        for key in dict.fromkeys(keys):        # preserve order, dedupe
            with self._lock:
                if dst in self._catalog.get(key, {}):
                    continue
            src = self.best_src(key, dst)
            if src is None:
                self.metrics.inc("fabric/missing_key")
            else:
                by_src.setdefault(src, []).append(key)
        moved, sim_total = 0, 0.0
        for src, group in sorted(by_src.items()):
            blobs = [(k, self.fabric.sites[src].store.get(k)) for k in group]
            nbytes = sum(len(d) for _, d in blobs)
            sim_total += self.fabric.transfer(src, dst, nbytes, transfers=1,
                                              tenant=tenant)
            for k, d in blobs:
                self.fabric.sites[dst].store.put(k, d)
                self.register(k, dst, len(d))
            moved += nbytes
        return moved, sim_total

    # ---------------------------------------------------------------- views
    def view(self, site: str, *, mirror: Optional[str] = None,
             mirror_prefixes: Sequence[str] = ("checkpoints/",),
             tenant: str = "") -> "SiteStore":
        return SiteStore(self, site, mirror=mirror,
                         mirror_prefixes=tuple(mirror_prefixes),
                         tenant=tenant)


class SiteStore(BlobCodecs):
    """What a pod at one site sees: the whole namespace, local-first.

    API-compatible with ``repro_torch.data.objectstore.ObjectStore`` (the
    Checkpointer, workflow and CONNECT steps run on either).  Non-local
    reads are metered pull-through copies; writes register in the
    catalog and, when a ``mirror`` is set, synchronously replicate
    matching prefixes off-site (crash-consistent: copies happen in write
    order, so a mirrored MANIFEST implies its mirrored shards)."""

    def __init__(self, fed: FederatedStore, site: str, *,
                 mirror: Optional[str] = None,
                 mirror_prefixes: Tuple[str, ...] = ("checkpoints/",),
                 tenant: str = ""):
        self.fed = fed
        self.site = site
        self.mirror = mirror
        self.mirror_prefixes = mirror_prefixes
        self.tenant = tenant        # bills this view's pulls/mirrors

    @property
    def root(self):
        return self.fed.fabric.sites[self.site].store.root

    def put(self, key: str, data: bytes) -> None:
        self.fed.put(key, data, self.site)
        if self.mirror and any(_under(key, p) for p in self.mirror_prefixes):
            if self.fed.fabric.sites[self.mirror].up:
                self.fed.replicate(key, self.mirror, tenant=self.tenant)
            else:
                self.fed.metrics.inc("fabric/mirror_skipped")

    def get(self, key: str) -> bytes:
        if not self.fed.exists(key):
            raise FileNotFoundError(key)
        if self.tenant:
            self.fed.replicate(key, self.site, tenant=self.tenant)
        return self.fed.get(key, self.site)

    def exists(self, key: str) -> bool:
        return self.fed.exists(key)

    def delete(self, key: str) -> bool:
        return self.fed.delete(key)

    def list(self, prefix: str = "") -> List[str]:
        return self.fed.list(prefix)

    def size(self, key: str) -> int:
        n = self.fed.nbytes(key)
        if n == 0 and not self.fed.exists(key):
            raise FileNotFoundError(key)
        return n

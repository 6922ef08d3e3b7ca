"""Fair-share preemptive scheduling over the federation.

The arbiter the shared fabric was missing: every tenant used to own the
whole fabric; now a ``FairShareScheduler`` decides whose pods run where,
using dominant-share accounting (DRF applied to the per-site device
pools) plus Borg-style priority preemption:

  * **queued jobs** are placed in rounds: among equal priorities the
    tenant with the LOWEST dominant share goes first, recomputed after
    every placement, so two equal-weight tenants hammering a saturated
    fabric interleave wave by wave instead of head-of-line blocking
    (the >2x FIFO skew measured by the JAX package's
    ``bench_vcluster_fairness``);
  * **capacity claims** are the elastic tenancy primitive: a training
    tenant claims "up to N devices at site S" and runs inside a
    ``TenantClusterView`` clamped to the claim's live ``granted`` count.
    Spare devices re-grow shrunk claims each reconcile pass (highest
    priority, then lowest share first);
  * **preemption** is checkpoint-then-evict: when a higher-priority
    tenant's job cannot fit, the scheduler shrinks lower-priority
    claims / jobs at the chosen site via the orchestrator's cooperative
    ``preempt_pod`` drain.  Victim training segments save a checkpoint
    and exit; the preempted batch job is requeued whole; a pod that
    ignores the drain past ``preempt_grace_s`` is hard-evicted.  Every
    decision is published to the monitor ``EventBus``.

The scheduler is deterministic when stepped manually (``step()``), and
self-driving with ``start()`` (a reconcile thread, period
``reconcile_s`` — the "one reconcile interval" that bounds monitor lag).

A copy of the JAX package's ``vcluster/scheduler.py``: the same policies,
the same decisions and the same ``sched`` bus actions.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.orchestrator import Job, JobSpec, Pod, PodState
from repro_torch.fabric.topology import Fabric, Site
from repro_torch.vcluster.monitor import EventBus
from repro_torch.vcluster.tenant import TenantSpec, VirtualCluster


@dataclass
class TenantJob:
    """One tenant's batch job riding through the scheduler."""
    seq: int
    tenant: str
    spec: JobSpec
    site_hint: Optional[str]
    submitted: float
    state: str = "queued"     # queued | running | done | failed | cancelled
    placements: List[Tuple[str, Job]] = field(default_factory=list)
    preemptions: int = 0
    done_ts: Optional[float] = None
    error: Optional[str] = None
    _event: threading.Event = field(default_factory=threading.Event)
    _preempting: bool = False    # a preemption was fired on its behalf
    _cancelled: bool = False     # user cancel: drained pods don't requeue

    @property
    def need(self) -> int:
        return self.spec.devices_per_pod * self.spec.replicas

    @property
    def site(self) -> Optional[str]:
        return self.placements[-1][0] if self.placements else None

    @property
    def job(self) -> Optional[Job]:
        return self.placements[-1][1] if self.placements else None

    def results(self):
        return self.job.results() if self.job else []

    def wait(self, timeout: float = 60.0) -> "TenantJob":
        if not self._event.wait(timeout):
            raise TimeoutError(f"tenant job {self.spec.name!r} "
                               f"({self.state}) not finished in {timeout}s")
        if self.state == "failed":
            raise RuntimeError(f"tenant job {self.spec.name!r} failed: "
                               f"{self.error}")
        return self


@dataclass(eq=False)        # identity semantics: claims are live handles
class CapacityClaim:
    """An elastic 'up to N devices at site S' reservation.

    ``granted`` is the live grant the tenant's ``TenantClusterView``
    clamps to; the scheduler shrinks it on preemption and re-grows it
    from spare capacity each pass.  ``min_devices`` is the floor
    preemption never crosses."""
    tenant: str
    site: str
    want: int
    min_devices: int = 0
    granted: int = 0
    released: bool = False
    _sched: Optional["FairShareScheduler"] = field(default=None, repr=False)

    def release(self) -> None:
        if self._sched is not None:
            self._sched.release_claim(self)


class FairShareScheduler:
    def __init__(self, fabric: Optional[Fabric] = None, *, fed=None,
                 bus: Optional[EventBus] = None, policy: str = "fair",
                 reconcile_s: float = 0.02, preempt_grace_s: float = 10.0):
        """``policy`` is "fair" (dominant-share + priority) or "fifo"
        (strict arrival order — the data-blind baseline the fairness
        benchmark measures against).  Pass ``fed`` (a FederatedStore) to
        enable tenant planners/stores; its fabric is used."""
        if fed is not None:
            fabric = fed.fabric
        if fabric is None:
            raise TypeError("FairShareScheduler needs a fabric or fed")
        if policy not in ("fair", "fifo"):
            raise ValueError(f"unknown policy {policy!r}")
        self.fabric = fabric
        self.fed = fed
        self.metrics = fabric.metrics
        self.bus = bus or EventBus(metrics=self.metrics)
        self.policy = policy
        self.reconcile_s = reconcile_s
        self.preempt_grace_s = preempt_grace_s
        self.tenants: Dict[str, VirtualCluster] = {}
        self._lock = threading.RLock()
        self._seq = itertools.count()
        self._pending: List[TenantJob] = []
        self._running: List[TenantJob] = []
        self._claims: List[CapacityClaim] = []
        # (cluster, pod, hard-evict deadline) for in-flight preemptions
        self._graces: List[Tuple[object, Pod, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- tenants
    def create_tenant(self, spec: TenantSpec) -> VirtualCluster:
        with self._lock:
            if spec.name in self.tenants:
                raise ValueError(f"tenant {spec.name!r} exists")
            vc = VirtualCluster(self, spec)
            self.tenants[spec.name] = vc
        for site in self.fabric.sites.values():
            self._ensure_ns(site, spec)
        self.bus.publish("sched", source=spec.name, action="tenant-created",
                         weight=spec.weight, priority=spec.priority)
        return vc

    def _ensure_ns(self, site: Site, spec: TenantSpec) -> None:
        quota = spec.site_quota
        if quota is None:
            quota = len(site.cluster.devices)
        if spec.namespace not in site.cluster.namespaces:
            site.cluster.create_namespace(spec.namespace, quota,
                                          tenant=spec.name)
        else:
            site.cluster.set_quota(spec.namespace, quota)

    # ----------------------------------------------------------- accounting
    def usage(self, tenant: str) -> Dict[str, int]:
        ns = self.tenants[tenant].spec.namespace
        out = {}
        for site in self.fabric.sites.values():
            n = site.cluster.namespaces.get(ns)
            out[site.name] = n.used_devices if n else 0
        return out

    def dominant_share(self, tenant: str) -> float:
        """DRF over per-site device pools: the tenant's most-contended
        site fraction, normalized by its fair-share weight."""
        spec = self.tenants[tenant].spec
        usage = self.usage(tenant)
        share = 0.0
        for site in self.fabric.up_sites():
            cap = len(site.cluster.online_devices)
            if cap <= 0:
                continue
            share = max(share, usage.get(site.name, 0) / cap)
        return share / spec.weight

    def _free(self, site: Site) -> int:
        return site.cluster.free_devices() if site.up else 0

    def _reserved_unused(self, site: Site, *,
                         exclude_tenant: Optional[str] = None) -> int:
        """Granted-but-unleased claim headroom at a site: devices a
        restarting elastic segment is about to reclaim.  Placement must
        not hand these to another tenant mid-restore."""
        out = 0
        ns = {name: site.cluster.namespaces.get(vc.spec.namespace)
              for name, vc in self.tenants.items()}
        for c in self._claims:
            if c.site != site.name or c.tenant == exclude_tenant:
                continue
            n = ns.get(c.tenant)
            out += max(0, c.granted - (n.used_devices if n else 0))
        return out

    def _available(self, site: Site, tenant: str) -> int:
        return self._free(site) - self._reserved_unused(
            site, exclude_tenant=tenant)

    def _total_usage(self, tenant: str) -> int:
        return sum(self.usage(tenant).values())

    def _priority(self, job: TenantJob) -> int:
        if job.spec.priority is not None:
            return job.spec.priority
        return self.tenants[job.tenant].spec.priority

    # -------------------------------------------------------------- submits
    def submit(self, tenant: str, spec: JobSpec, *,
               site: Optional[str] = None) -> TenantJob:
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        job = TenantJob(seq=next(self._seq), tenant=tenant, spec=spec,
                        site_hint=site, submitted=time.monotonic())
        with self._lock:
            self._pending.append(job)
        self.metrics.inc(f"vcluster/queued/{tenant}")
        self.bus.publish("sched", source=tenant, action="queued",
                         job=spec.name, need=job.need)
        return job

    def claim(self, tenant: str, site: str, *, want: int,
              min_devices: int = 0) -> CapacityClaim:
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        spec = self.tenants[tenant].spec
        self._ensure_ns(self.fabric.sites[site], spec)
        c = CapacityClaim(tenant=tenant, site=site, want=want,
                          min_devices=min_devices, _sched=self)
        with self._lock:
            self._claims.append(c)
            give = min(want, max(0, self._available(
                self.fabric.sites[site], tenant)))
            ceiling = spec.max_devices
            if ceiling is not None:
                give = min(give, max(0, ceiling - self._total_usage(tenant)))
            c.granted = give
        self.bus.publish("sched", source=tenant, action="claimed",
                         site=site, want=want, granted=c.granted)
        return c

    def resize_claim(self, claim: CapacityClaim, want: int) -> int:
        """Elastically regrow or shrink a live claim in place — the
        serving autoscaler's capacity path: replicas scale up only as far
        as the tenant's fair share allows, and scale-down returns the
        devices to the pool immediately.  Shrinking always succeeds;
        growth is clamped by site availability (excluding the claim's own
        unleased headroom) and the tenant's ``max_devices`` ceiling.
        Returns the new grant."""
        if claim.released:
            raise ValueError("cannot resize a released claim")
        spec = self.tenants[claim.tenant].spec
        with self._lock:
            claim.want = want
            if want <= claim.granted:
                claim.granted = want
            else:
                site = self.fabric.sites[claim.site]
                used = self.usage(claim.tenant).get(claim.site, 0)
                own_headroom = max(0, claim.granted - used)
                avail = max(0, self._available(site, claim.tenant)
                            - own_headroom)
                grow = min(want - claim.granted, avail)
                ceiling = spec.max_devices
                if ceiling is not None:
                    grow = min(grow, max(0, ceiling
                                         - self._total_usage(claim.tenant)
                                         - own_headroom))
                claim.granted += max(0, grow)
        self.bus.publish("sched", source=claim.tenant, action="resized",
                         site=claim.site, want=want, granted=claim.granted)
        return claim.granted

    def release_claim(self, claim: CapacityClaim) -> None:
        with self._lock:
            claim.released = True
            claim.granted = 0
            if claim in self._claims:
                self._claims.remove(claim)
        self.bus.publish("sched", source=claim.tenant, action="released",
                         site=claim.site)

    def cancel(self, tj: TenantJob, *, reason: str = "cancelled") -> bool:
        """Cancel one tenant job.  A queued job dequeues immediately; a
        running one is checkpoint-then-evict drained (cooperative
        ``preempt_pod`` + the usual hard-evict grace) and ``_reap``
        marks it terminal ``cancelled`` instead of requeueing.  Returns
        False when the job is already terminal."""
        with self._lock:
            if tj.state in ("done", "failed", "cancelled"):
                return False
            tj._cancelled = True
            if tj in self._pending:
                self._pending.remove(tj)
                tj.state, tj.done_ts = "cancelled", time.monotonic()
                tj._event.set()
                cluster, job = None, None
            else:
                cluster = self.fabric.sites[tj.site].cluster \
                    if tj.site else None
                job = tj.job
        if cluster is None or job is None:
            self.metrics.inc(f"vcluster/cancelled/{tj.tenant}")
            self.bus.publish("sched", source=tj.tenant, action="cancelled",
                             job=tj.spec.name)
            return True
        deadline = time.monotonic() + self.preempt_grace_s
        for pod in job.pods:
            if pod.state in (PodState.PENDING, PodState.RUNNING):
                cluster.preempt_pod(pod, reason=reason)
                with self._lock:
                    self._graces.append((cluster, pod, deadline))
        self.bus.publish("sched", source=tj.tenant,
                         action="cancel-requested", job=tj.spec.name)
        return True

    # ------------------------------------------------------------ reconcile
    def step(self) -> int:
        """One reconcile pass: reap, expire preempt graces, place queued
        jobs fairly, re-grow claims, run site controllers.  Returns the
        number of placements made."""
        with self._lock:
            self._reap()
            self._expire_graces()
            placed = self._place_pending()
            self._regrow_claims()
        for site in self.fabric.up_sites():
            site.cluster.reconcile()
        return placed

    def _stranded(self, tj: TenantJob) -> bool:
        """A placed job whose site can no longer run it: the whole site
        is down, or node churn shrank it below the job's device need.
        ``step()`` only reconciles UP sites, so a drained pod at a dead
        site would otherwise sit FAILED-under-backoff forever — the
        cross-layer deadlock the chaos scenarios flush out."""
        if tj.site is None:
            return False
        site = self.fabric.sites[tj.site]
        return (not site.up or
                len(site.cluster.online_devices) < tj.spec.devices_per_pod)

    def _reap(self) -> None:
        still = []
        for tj in self._running:
            job = tj.job
            if job.succeeded:
                tj.state, tj.done_ts = "done", time.monotonic()
                tj._event.set()
                self.metrics.inc(f"vcluster/done/{tj.tenant}")
                self.bus.publish("sched", source=tj.tenant, action="done",
                                 job=tj.spec.name, site=tj.site)
            elif job.terminal and (job.preempted or self._stranded(tj)):
                # evicted — or stranded on a dead/shrunken site: requeue
                # the whole job on the survivors.  Its fn is expected to
                # be resumable (at-least-once, like the work queue).
                # Any FAILED-under-backoff sibling pod must be retired
                # first, or the site reconciler would respawn it while
                # the requeued job runs the same fn again.
                cluster = self.fabric.sites[tj.site].cluster
                for p in job.pods:
                    if p.state == PodState.FAILED and \
                            p.restarts < job.spec.backoff_limit:
                        cluster.retire_pod(p)
                if tj._cancelled:
                    # the drain was a user cancel (FairShareScheduler.
                    # cancel), not a fair-share eviction: terminal, with
                    # whatever the pods checkpointed preserved
                    tj.state, tj.done_ts = "cancelled", time.monotonic()
                    tj._event.set()
                    self.metrics.inc(f"vcluster/cancelled/{tj.tenant}")
                    self.bus.publish("sched", source=tj.tenant,
                                     action="cancelled", job=tj.spec.name)
                    continue
                tj.state = "queued"
                tj.preemptions += 1
                tj._preempting = False
                self._pending.append(tj)
                self.metrics.inc(f"vcluster/requeued/{tj.tenant}")
                self.bus.publish("sched", source=tj.tenant,
                                 action="requeued", job=tj.spec.name,
                                 preemptions=tj.preemptions)
            elif job.failed:
                tj.state, tj.done_ts = "failed", time.monotonic()
                tj.error = next((p.error for p in job.pods if p.error), None)
                tj._event.set()
                self.metrics.inc(f"vcluster/failed/{tj.tenant}")
                self.bus.publish("sched", source=tj.tenant, action="failed",
                                 job=tj.spec.name)
            else:
                still.append(tj)     # running, or FAILED under backoff
        self._running = still

    def _expire_graces(self) -> None:
        now = time.monotonic()
        keep = []
        for cluster, pod, deadline in self._graces:
            if pod.state not in (PodState.PENDING, PodState.RUNNING):
                continue                      # exited on its own
            if now >= deadline:
                cluster.finish_preempt(pod)   # hard evict
                self.metrics.inc("vcluster/preempt_hard")
            else:
                keep.append((cluster, pod, deadline))
        self._graces = keep

    def _order(self, jobs: List[TenantJob]) -> List[TenantJob]:
        if self.policy == "fifo":
            return sorted(jobs, key=lambda j: j.seq)
        share = {t: self.dominant_share(t)
                 for t in {j.tenant for j in jobs}}
        return sorted(jobs, key=lambda j: (-self._priority(j),
                                           share[j.tenant], j.seq))

    def _site_candidates(self, tj: TenantJob) -> List[Site]:
        if tj.site_hint is not None:
            s = self.fabric.sites[tj.site_hint]
            return [s] if s.up else []
        cands = [s for s in self.fabric.up_sites()
                 if len(s.cluster.online_devices) >= max(tj.need, 1)]
        cands.sort(key=lambda s: (-self._available(s, tj.tenant),
                                  s.queue_depth(), s.name))
        return cands

    def _place_pending(self) -> int:
        placed = 0
        while self._pending:
            # re-rank every round: each placement moves dominant shares
            order = self._order(self._pending)
            launched = False
            for tj in order:
                site = self._fit(tj)
                if site is not None and self._launch(tj, site):
                    placed += 1
                    launched = True
                    break
            if not launched:
                # nothing fits; let the HIGHEST-ranked stuck job try to
                # preempt (one preemption wave per pass, no storms)
                for tj in order:
                    if not tj._preempting and self._preempt_for(tj):
                        break
                break
        return placed

    def _fit(self, tj: TenantJob) -> Optional[Site]:
        spec = self.tenants[tj.tenant].spec
        if spec.max_devices is not None and \
                self._total_usage(tj.tenant) + tj.need > spec.max_devices:
            return None
        for site in self._site_candidates(tj):
            if self._available(site, tj.tenant) >= tj.need:
                return site
        return None

    def _launch(self, tj: TenantJob, site: Site) -> bool:
        spec = self.tenants[tj.tenant].spec
        self._ensure_ns(site, spec)
        try:
            job = site.cluster.submit(spec.namespace, tj.spec)
        except RuntimeError:
            return False      # lost an allocation race; stays pending
        tj.placements.append((site.name, job))
        tj.state = "running"
        tj._preempting = False
        self._pending.remove(tj)
        self._running.append(tj)
        self.metrics.inc(f"vcluster/placed/{tj.tenant}")
        self.bus.publish("sched", source=tj.tenant, action="placed",
                         job=tj.spec.name, site=site.name, need=tj.need)
        return True

    # ------------------------------------------------------------ preemption
    def _victims_at(self, site: Site, prio: int,
                    requester: str) -> List[Tuple[int, float, Pod, str]]:
        """Live pods at a site owned by preemptible tenants of strictly
        lower priority, worst-first (lowest priority, highest share)."""
        out = []
        for name, vc in self.tenants.items():
            vspec = vc.spec
            if name == requester or not vspec.preemptible or \
                    vspec.priority >= prio:
                continue
            vshare = self.dominant_share(name)
            for job in site.cluster.jobs:
                for pod in job.pods:
                    if pod.ctx.namespace == vspec.namespace and \
                            pod.state in (PodState.PENDING,
                                          PodState.RUNNING) and \
                            not pod.ctx.preempt.is_set():
                        out.append((vspec.priority, -vshare, pod, name))
        out.sort(key=lambda v: (v[0], v[1]))
        return out

    def _claim_of(self, pod: Pod, tenant: str,
                  site: Site) -> Optional[CapacityClaim]:
        """The capacity claim a victim pod runs under, if any.  Pods of
        scheduler-placed batch jobs are NOT claim pods even when their
        tenant also holds a claim at the site — evicting them must not
        shrink the (untouched) training grant."""
        for tj in self._running:
            if tj.tenant == tenant and tj.job is not None and \
                    any(p is pod for p in tj.job.pods):
                return None
        return next((c for c in self._claims
                     if c.tenant == tenant and c.site == site.name), None)

    def _preempt_for(self, tj: TenantJob) -> bool:
        """Checkpoint-then-evict enough lower-priority devices for ``tj``."""
        prio = self._priority(tj)
        for site in self._site_candidates(tj):
            victims = self._victims_at(site, prio, tj.tenant)
            # claim floors: never shrink a claim below its min_devices
            floor_left = {id(c): c.granted - c.min_devices
                          for c in self._claims if c.site == site.name}
            have = self._available(site, tj.tenant)
            chosen = []               # (pod, tenant, claim-or-None)
            for _, _, pod, tenant in victims:
                if have >= tj.need:
                    break
                take = len(pod.ctx.devices)
                if take == 0:
                    continue          # evicting a CPU pod frees nothing
                claim = self._claim_of(pod, tenant, site)
                if claim is not None:
                    if floor_left.get(id(claim), 0) < take:
                        continue          # would pierce the claim floor
                    floor_left[id(claim)] -= take
                have += take
                chosen.append((pod, tenant, claim))
            if have < tj.need:
                continue
            deadline = time.monotonic() + self.preempt_grace_s
            for pod, tenant, claim in chosen:
                if claim is not None:
                    claim.granted = max(claim.min_devices,
                                        claim.granted -
                                        len(pod.ctx.devices))
                site.cluster.preempt_pod(
                    pod, reason=f"fair-share: {tj.tenant} "
                                f"(prio {prio}) needs {tj.need} devices")
                self._graces.append((site.cluster, pod, deadline))
                self.metrics.inc(f"vcluster/preemptions/{tenant}")
                self.bus.publish("sched", source=tenant, action="preempt",
                                 pod=pod.ctx.pod_id, site=site.name,
                                 for_tenant=tj.tenant)
            if chosen:
                tj._preempting = True
                return True
        return False

    # --------------------------------------------------------------- claims
    def _regrow_claims(self) -> None:
        """Hand spare devices back to shrunk claims (priority desc, then
        lowest dominant share) — but never devices a queued job could
        use: pending work outranks elastic headroom."""
        for site in self.fabric.up_sites():
            spare = self._free(site) - self._reserved_unused(site)
            spare -= sum(tj.need for tj in self._pending
                         if tj.site_hint in (None, site.name))
            if spare <= 0:
                continue
            claims = [c for c in self._claims
                      if c.site == site.name and c.granted < c.want]
            claims.sort(key=lambda c: (
                -self.tenants[c.tenant].spec.priority,
                self.dominant_share(c.tenant)))
            for c in claims:
                if spare <= 0:
                    break
                ceiling = self.tenants[c.tenant].spec.max_devices
                add = min(c.want - c.granted, spare)
                if ceiling is not None:
                    # committed = everything leased plus the grant's
                    # still-unleased headroom (don't double-count the
                    # leased part of the grant)
                    used_here = self.usage(c.tenant).get(c.site, 0)
                    committed = self._total_usage(c.tenant) + \
                        max(0, c.granted - used_here)
                    add = min(add, max(0, ceiling - committed))
                if add > 0:
                    c.granted += add
                    spare -= add
                    self.metrics.inc(f"vcluster/grants/{c.tenant}", add)
                    self.bus.publish("sched", source=c.tenant,
                                     action="grant", site=site.name,
                                     granted=c.granted)

    # ----------------------------------------------------------------- loop
    def start(self) -> "FairShareScheduler":
        """Run the reconcile loop in a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.step()
                self._stop.wait(self.reconcile_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fair-share-scheduler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "FairShareScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

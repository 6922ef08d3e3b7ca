"""Virtual clusters — per-tenant slices of the shared federation.

The paper's platform is a *shared appliance*: ~30 institutions on one
fabric, each expecting "virtual cluster management ... in a dynamically
scalable fashion" (§I contribution 4, §IV).  A ``VirtualCluster`` is one
tenant's handle on the fabric: a ``TenantSpec`` (fair-share weight,
priority, elastic min/max devices), a namespace on every site cluster
(the orchestrator's per-tenant quota accounting), and tenant-scoped
entry points for each workload family —

  * ``submit``       — batch jobs through the fair-share scheduler;
  * ``run_elastic``  — self-healing training on a preemptible capacity
                       claim (checkpoint-then-evict, auto-resume);
  * ``serve``        — a continuous-batching inference pod that yields
                       its slot cooperatively when preempted;
  * ``workflow``     — a placed, measured step DAG whose staging is
                       billed to the tenant and scored against other
                       tenants' link backlog.

``TenantClusterView`` is the trick that lets the EXISTING elastic stack
run multi-tenant unchanged: it forwards everything to the real site
cluster but clamps ``online_devices`` to the tenant's live grant, so the
churn controller plans meshes inside the tenant's slice and a grant
shrink looks exactly like node churn (drain -> re-mesh -> restore).

A copy of the JAX package's ``vcluster/tenant.py``.  Two differences: the
work computes on the device of the site the scheduler chose.
``run_elastic`` trains on the claimed site's ``compute_device`` (the
spec's ``device`` is replaced by it), and ``serve``'s ``build_engine``
takes that device, ``build_engine(device)``, resolved inside the pod
from the site the pod was placed at (JAX's takes no argument and builds
on the process's default device).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core.orchestrator import Cluster, JobSpec


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract with the shared fabric."""
    name: str
    weight: float = 1.0          # fair-share weight (2.0 = twice the share)
    priority: int = 0            # higher may preempt strictly lower
    preemptible: bool = True     # may THIS tenant's pods be evicted
    min_devices: int = 0         # floor a capacity claim never drops below
    max_devices: Optional[int] = None   # fabric-wide ceiling (elastic max)
    site_quota: Optional[int] = None    # per-site namespace device quota

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")

    @property
    def namespace(self) -> str:
        return f"tenant-{self.name}"


class TenantClusterView:
    """One tenant's window onto a site ``Cluster``.

    Forwards every attribute to the real cluster; only
    ``online_devices`` is clamped to the tenant's live device grant, so
    mesh planning (ChurnController / rescale_plan) stays inside the
    tenant's slice and grant changes read as node churn.
    """

    def __init__(self, cluster: Cluster, grant_fn):
        self._cluster = cluster
        self._grant = grant_fn

    @property
    def online_devices(self):
        return self._cluster.online_devices[:max(0, int(self._grant()))]

    def __getattr__(self, name):
        return getattr(self._cluster, name)

    def __repr__(self):
        return (f"TenantClusterView(site={self._cluster.site!r}, "
                f"grant={int(self._grant())})")


class VirtualCluster:
    """A tenant's handle — constructed by FairShareScheduler.create_tenant."""

    def __init__(self, sched, spec: TenantSpec):
        self.sched = sched
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def namespace(self) -> str:
        return self.spec.namespace

    # ------------------------------------------------------------ accounting
    def usage(self) -> Dict[str, int]:
        """Devices currently leased to this tenant, per site."""
        return self.sched.usage(self.name)

    def dominant_share(self) -> float:
        """This tenant's dominant share: its most-contended per-site
        device fraction, divided by its weight (DRF accounting)."""
        return self.sched.dominant_share(self.name)

    # -------------------------------------------------------------- workloads
    def submit(self, spec: JobSpec, *, site: Optional[str] = None):
        """Queue a batch job; the fair-share scheduler places it."""
        return self.sched.submit(self.name, spec, site=site)

    def claim(self, site: str, devices: int, *,
              min_devices: Optional[int] = None):
        """Register an elastic capacity claim at a site (see scheduler)."""
        floor = self.spec.min_devices if min_devices is None else min_devices
        return self.sched.claim(self.name, site, want=devices,
                                min_devices=floor)

    def view(self, site: str, claim=None) -> TenantClusterView:
        """The tenant's clamped view of a site cluster.  With a claim the
        grant is the claim's; otherwise the namespace quota."""
        cluster = self.sched.fabric.sites[site].cluster
        if claim is not None:
            return TenantClusterView(cluster, lambda: claim.granted)
        ns = self.namespace
        return TenantClusterView(
            cluster,
            lambda: cluster.namespaces[ns].device_quota
            if ns in cluster.namespaces else 0)

    def planner(self, **kw):
        """A tenant-tagged PlacementPlanner: staging billed to this
        tenant, scoring penalized by other tenants' link backlog."""
        from repro_torch.fabric.placement import PlacementPlanner
        if self.sched.fed is None:
            raise RuntimeError("scheduler has no FederatedStore: construct "
                               "FairShareScheduler(fed=...) for placement")
        return PlacementPlanner(self.sched.fed, tenant=self.name, **kw)

    def store(self, site: str, **kw):
        """A tenant-billed SiteStore view at ``site``."""
        if self.sched.fed is None:
            raise RuntimeError("scheduler has no FederatedStore")
        return self.sched.fed.view(site, tenant=self.name, **kw)

    def workflow(self, name: str, **kw):
        """A measured step DAG running as this tenant (placed by the
        tenant planner, events on the scheduler's bus)."""
        from repro_torch.core.workflow import Workflow
        if "planner" not in kw and not ("cluster" in kw and "store" in kw):
            kw["planner"] = self.planner()   # lazy: a caller-supplied
            # planner (or cluster+store) must not require a fed store
        kw.setdefault("namespace", self.namespace)
        kw.setdefault("bus", self.sched.bus)
        return Workflow(name, **kw)

    def run_elastic(self, tspec, *, site: str, devices: int,
                    store=None, min_devices: Optional[int] = None,
                    stop=None, on_trainer=None) -> Dict[str, Any]:
        """Self-healing elastic training inside this tenant's slice.

        Registers a capacity claim for up to ``devices`` at ``site`` and
        runs an ``ElasticTrainer`` on the tenant's clamped cluster view.
        Fair-share preemption (the scheduler shrinking the grant and
        preempt-draining the segment pod) reads exactly like node churn:
        the segment checkpoints on the way out, the trainer's
        ``wait_for_capacity`` rides out the eviction (bounded by the
        spec's ``rejoin_timeout_s``), and training resumes from the last
        checkpoint when the grant returns — steps lost stay within the
        elastic path's existing ``ckpt_every`` bound.  The trainer computes
        on the site's ``compute_device``, whatever ``tspec.device`` says.

        ``stop`` (a ``threading.Event``, e.g. a ``repro_torch.api`` Handle's
        cancel signal) ends the run cooperatively: the live segment
        checkpoints and exits, and the partial result is returned.
        """
        from repro_torch.elastic.trainer import ElasticTrainer
        claim = self.claim(site, devices, min_devices=min_devices)
        view = self.view(site, claim)
        spec = dataclasses.replace(tspec, namespace=self.namespace,
                                   device=view.compute_device)
        trainer = ElasticTrainer(view, spec, store=store,
                                 metrics=self.sched.metrics, stop=stop)
        if on_trainer is not None:
            on_trainer(trainer)
        try:
            return trainer.run()
        finally:
            claim.release()

    def serve(self, build_engine, requests, *, site: Optional[str] = None,
              lease_timeout: float = 30.0, default_max_new: int = 16,
              should_stop=None):
        """Submit a preemptible continuous-batching serving pod.

        ``build_engine(device)`` must return a
        ``repro_torch.serving.ServingEngine`` on ``device``, the compute
        device of the site the pod was placed at (constructed inside the
        pod, so its weights and kernel builds land on the pod's clock).
        The engine polls the pod's ``should_stop`` between fused
        decode steps: a preemption exits cleanly and unacked requests'
        leases expire back to the queue for the next placement.  An
        extra ``should_stop`` callable (e.g. a ``repro_torch.api`` Handle's
        cancel signal) is OR-ed in, so an API cancel drains the engine
        the same cooperative way a fair-share eviction does.
        Returns (TenantJob, WorkQueue).
        """
        from repro_torch.core.queue import WorkQueue
        queue = WorkQueue(list(requests), lease_timeout=lease_timeout)

        def serve_pod(ctx):
            engine = build_engine(
                self.sched.fabric.sites[ctx.site].cluster.compute_device)

            def stop():
                return ctx.should_stop() or (should_stop is not None and
                                             should_stop())

            results, _ = engine.run(queue, default_max_new=default_max_new,
                                    should_stop=stop)
            return results

        job = self.submit(JobSpec(f"serve-{self.name}", serve_pod,
                                  devices_per_pod=1), site=site)
        return job, queue

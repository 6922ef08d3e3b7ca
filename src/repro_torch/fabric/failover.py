"""Cross-site failover — survive the loss of a whole appliance.

Within one site, ``repro_torch.elastic`` already self-heals node churn: drain,
re-mesh, restore, rescale accumulation.  What it cannot survive is the
*site* dying — the cluster drops below one model replica and the churn
controller escalates with ``CapacityLostError``.  This supervisor owns
that case, the paper's multi-appliance contract (§IV-V):

  1. the job trains at its placed site through a ``SiteStore`` whose
     ``mirror`` replicates every checkpoint write to a second site
     (metered over the link — durability is not free);
  2. on escalation, the planner re-places the job over the surviving
     sites using the checkpoint keys as the job's dataset (so it lands
     where the mirror is, if it can);
  3. surviving replicas of ``checkpoints/`` are batch-replicated to the
     new site, a new trainer resumes from the newest *reachable*
     manifest, and the shared run report keeps accumulating.

Steps checkpointed at the dead site but never mirrored are honestly
lost — they show up as ``steps_lost``, exactly like intra-site churn.

A port of the JAX package's ``fabric/failover.py`` over the port's
``ElasticTrainer``.  Each site's trainer computes on that site's cluster's
``compute_device`` (the spec's ``device`` is replaced per site).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.metrics import Registry
from repro_torch.elastic.controller import CapacityLostError
from repro_torch.elastic.trainer import (ElasticRunReport, ElasticTrainer,
                                         ElasticTrainSpec)
from repro_torch.fabric.federated import FederatedStore
from repro_torch.fabric.placement import PlacementPlanner


@dataclass
class Migration:
    """One cross-site move of a training job."""
    from_site: str
    to_site: str
    at_step: int                 # last completed step before the move
    bytes_moved: int
    transfer_s: float


@dataclass
class FederatedTrainResult:
    sites: List[str] = field(default_factory=list)
    migrations: List[Migration] = field(default_factory=list)
    report: Optional[ElasticRunReport] = None
    out: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"sites": self.sites,
                "migrations": [dataclasses.asdict(m) for m in self.migrations],
                "report": self.report.to_json() if self.report else None}


def run_elastic_federated(planner: PlacementPlanner, spec: ElasticTrainSpec,
                          *, ckpt_prefix: str = "checkpoints",
                          max_migrations: int = 3,
                          metrics: Optional[Registry] = None,
                          stop=None, on_trainer=None) -> FederatedTrainResult:
    """Run elastic training on the fabric, failing over across sites.

    The spec's ``base_shape`` is the preferred mesh; each site hosts
    whatever slice of it fits (the in-site churn controller shrinks the
    data axis as usual).  ``rejoin_timeout_s`` bounds how long a dead
    site is waited on before the job migrates.  ``stop`` (a
    ``threading.Event``, e.g. a ``repro_torch.api`` Handle's cancel signal)
    drains the current site's trainer cooperatively — it checkpoints
    and exits — and the partial result is returned without migrating.
    ``on_trainer`` (a callable) observes each site's ElasticTrainer as
    it is created (live progress probing across migrations).
    """
    fed: FederatedStore = planner.fed
    fabric = fed.fabric
    metrics = metrics or fabric.metrics
    result = FederatedTrainResult()
    report: Optional[ElasticRunReport] = None
    carried_losses: Dict[int, float] = {}
    ckpt_inputs = [ckpt_prefix + "/*"]
    # smallest cluster that can host one model replica: every non-data axis
    # of the preferred mesh is weight-structural and cannot shrink
    di = spec.mesh_axes.index("data")
    replica = int(np.prod([s for j, s in enumerate(spec.base_shape)
                           if j != di]) or 1)

    def _bw(a: str, b: str) -> float:
        try:
            link = fabric.link(a, b)
        except ValueError:
            return -1.0
        return link.bytes_per_s if link else float("inf")

    while True:
        placement = planner.place(ckpt_inputs, devices=replica)
        site = fabric.sites[placement.site]
        # mirror checkpoints to the best-connected OTHER live site (storage
        # only — it need not be able to host the job itself)
        mirrors = sorted((s.name for s in fabric.up_sites()
                          if s.name != site.name),
                         key=lambda n: -_bw(site.name, n))
        store = fed.view(site.name, mirror=mirrors[0] if mirrors else None,
                         mirror_prefixes=(ckpt_prefix + "/",))
        # stage surviving checkpoint replicas at the new home before resuming
        staged_b, staged_s = planner.prestage(ckpt_inputs, site.name)
        if result.sites:
            at = report.segments[-1].end if report and report.segments else -1
            result.migrations.append(Migration(
                from_site=result.sites[-1], to_site=site.name, at_step=at,
                bytes_moved=staged_b, transfer_s=staged_s))
            metrics.inc("fabric/migrations")
        result.sites.append(site.name)
        site_spec = dataclasses.replace(
            spec, device=site.cluster.compute_device)
        trainer = ElasticTrainer(site.cluster, site_spec, store=store,
                                 metrics=metrics, report=report, stop=stop)
        if on_trainer is not None:
            on_trainer(trainer)
        # the loss log is host state, not checkpoint state: carry it over
        # so the finished run has one loss per step across every site
        trainer._losses.update(carried_losses)
        report = trainer.report
        try:
            result.out = trainer.run()
            result.report = report
            metrics.gauge("fabric/train_migrations", len(result.migrations))
            return result
        except CapacityLostError:
            carried_losses.update(trainer._losses)
            if stop is not None and stop.is_set():
                raise           # cancelled mid-outage: don't migrate
            if len(result.migrations) >= max_migrations:
                raise
            if not any(s.name != site.name
                       for s in planner.candidates(replica)):
                raise   # nowhere left to go
            if spec.verbose:
                print(f"[fabric] site {site.name!r} lost capacity -> "
                      f"failing the job over")

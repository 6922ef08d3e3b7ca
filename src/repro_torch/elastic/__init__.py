"""Self-healing elastic training (paper §V: "nodes can join and leave the
cluster at any time"), a port of the JAX package's ``repro.elastic``.

``ElasticTrainer`` runs training as a *supervised Job* on the
Kubernetes-style ``repro_torch.core.orchestrator.Cluster``: a churn
controller watches node events; on failure the affected pods are drained,
a rescale plan shrinks the logical mesh's data axis over the survivors,
state is restored from the latest checkpoint, and gradient accumulation
is raised so the global batch stays constant — then the mesh scales back
up when nodes rejoin.

Modules:
  * ``batch``      — global-batch-invariant accumulation math (BatchPlan)
  * ``controller`` — ChurnController: node-churn events -> rescale decisions
  * ``trainer``    — ElasticTrainer: the supervised training control loop
"""
from repro_torch.elastic.batch import BatchPlan, batch_plan
from repro_torch.elastic.controller import ChurnController, Decision
from repro_torch.elastic.trainer import (ElasticRunReport, ElasticTrainer,
                                         ElasticTrainSpec, SegmentRecord,
                                         UnschedulableError)

__all__ = [
    "BatchPlan", "batch_plan",
    "ChurnController", "Decision",
    "ElasticRunReport", "ElasticTrainer", "ElasticTrainSpec", "SegmentRecord",
    "UnschedulableError",
]

"""The unified declarative workload API — one manifest-driven control
plane for train / serve / batch / workflow / RL on a cluster or a
multi-site fabric (the JAX package's ``api``, with the cluster and fabric
backends).

    from repro_torch.api import Session, TrainJob

    session = Session(cluster=Cluster())
    handle = session.apply(TrainJob(name="demo", steps=20))
    out = handle.wait()
"""
from repro_torch.api.resources import (API_VERSION, BatchJob, KINDS,
                                       ManifestError, RLJob, ServeJob,
                                       TrainJob, WorkflowRun, WorkloadSpec,
                                       from_json, from_manifest,
                                       load_manifest, resolve_entrypoint)
from repro_torch.api.session import (Handle, Session, TERMINAL_STATES,
                                     WorkloadState, WorkloadStatus)

__all__ = [
    "API_VERSION", "BatchJob", "Handle", "KINDS", "ManifestError", "RLJob",
    "ServeJob", "Session", "TERMINAL_STATES", "TrainJob", "WorkflowRun",
    "WorkloadSpec", "WorkloadState", "WorkloadStatus", "from_json",
    "from_manifest", "load_manifest", "resolve_entrypoint",
]

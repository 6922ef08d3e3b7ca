"""Multi-site federation (paper §I, §IV): sites + bandwidth-modeled links,
a single content-addressed namespace with per-site replicas, locality-aware
placement, and cross-site elastic failover.  A port of the JAX package's
``fabric``."""
from repro_torch.fabric.topology import Fabric, Link, Site
from repro_torch.fabric.federated import FederatedStore, SiteStore
from repro_torch.fabric.placement import Placement, PlacementPlanner
from repro_torch.fabric.failover import (FederatedTrainResult, Migration,
                                   run_elastic_federated)

__all__ = [
    "Fabric", "Link", "Site",
    "FederatedStore", "SiteStore",
    "Placement", "PlacementPlanner",
    "FederatedTrainResult", "Migration", "run_elastic_federated",
]

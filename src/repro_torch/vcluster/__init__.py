"""Multi-tenant virtual clusters (paper §I contribution 4, §IV): tenant
slices of the federation, a dominant-share fair scheduler with
checkpoint-then-evict preemption, and the near-real-time monitor bus."""
from repro_torch.vcluster.monitor import Event, EventBus, Subscription
from repro_torch.vcluster.scheduler import (CapacityClaim, FairShareScheduler,
                                            TenantJob)
from repro_torch.vcluster.tenant import (TenantClusterView, TenantSpec,
                                         VirtualCluster)

__all__ = [
    "Event", "EventBus", "Subscription",
    "CapacityClaim", "FairShareScheduler", "TenantJob",
    "TenantClusterView", "TenantSpec", "VirtualCluster",
]

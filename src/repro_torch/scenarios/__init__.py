"""Production-chaos scenario harness — replay, inject, grade.

The closing argument for the stack: drive production-shaped traffic
(``traffic``) through the multi-site, multi-tenant fabric while a
scheduled failure menu (``chaos``) churns the infrastructure underneath,
then grade every tenant's SLO attainment, goodput and chargeback
(``grade``).  ``driver`` ties the three together through the declarative
``Session`` API.  A copy of the JAX package's ``scenarios``.
"""
from repro_torch.scenarios.chaos import (ChaosEvent, ChaosInjector,
                                         ChaosSchedule)
from repro_torch.scenarios.driver import (BurstPlan, ScenarioResult,
                                          ServePlan, TrainPlan, run_scenario)
from repro_torch.scenarios.grade import (SLO, Price, ScenarioSpec,
                                         TenantGrade, chargeback, grade_table,
                                         grade_tenant, percentile)
from repro_torch.scenarios.traffic import (BurstOverlay, DiurnalRate,
                                           TrafficShape, slice_window)

__all__ = [
    "BurstOverlay", "BurstPlan", "ChaosEvent", "ChaosInjector",
    "ChaosSchedule", "DiurnalRate", "Price", "SLO", "ScenarioResult",
    "ScenarioSpec", "ServePlan", "TenantGrade", "TrafficShape",
    "TrainPlan", "chargeback", "grade_table", "grade_tenant",
    "percentile", "run_scenario", "slice_window",
]

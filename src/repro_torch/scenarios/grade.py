"""SLO grading and chargeback — the scenario's report card.

The AI_INFN operations papers grade a federated platform per tenant:
did serving hold its latency SLOs while the infrastructure churned, how
much offered load became goodput, what did co-tenant training lose to
preemption, and what does each tenant owe for the bytes it moved and
the devices it leased.  ``grade_tenant`` computes exactly that from the
raw samples the run produced:

  * **attainment** — p99 TTFT / p99 request latency (nearest-rank, the
    same percentile rule as ``Series.stats``) against the tenant's
    ``SLO`` targets, plus a goodput floor (served / offered);
  * **goodput** — served request rate vs. offered load over the sim
    horizon; waves the platform failed count as *rejected*, never
    silently dropped (served + rejected == offered, asserted by the
    chaos regression);
  * **training collateral** — ``steps_lost`` / ``recoveries`` straight
    from the ``ElasticRunReport``;
  * **chargeback** — $-style cost from the platform's own meters:
    ``fabric/tenant/<t>/bytes_moved`` x ``Price.per_gb`` plus
    ``lease_device_s/tenant-<t>`` x ``Price.per_device_s``.

A copy of the JAX package's ``scenarios/grade.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, identical to ``Series.stats`` so a grade
    recomputed from raw samples matches the serving report."""
    vals = sorted(values)
    if not vals:
        return 0.0
    n = len(vals)
    return vals[min(n - 1, max(0, int(round(q / 100 * (n - 1)))))]


@dataclass(frozen=True)
class SLO:
    """One tenant's targets.  ``None`` disables a latency verdict (a
    training-only tenant has no TTFT); ``min_goodput`` is the fraction
    of offered requests that must be served (0 disables)."""
    p99_ttft_s: Optional[float] = None
    p99_latency_s: Optional[float] = None
    min_goodput: float = 0.0


@dataclass(frozen=True)
class Price:
    """The chargeback rate card (arbitrary currency units)."""
    per_gb: float = 0.09          # egress-style $/GB moved across sites
    per_device_s: float = 0.004   # accelerator lease $/device-second


@dataclass(frozen=True)
class ScenarioSpec:
    """What a scenario promises: how long it runs (sim seconds), how
    many serve waves the horizon splits into, and each tenant's SLO."""
    name: str
    horizon_s: float
    windows: int
    slos: Dict[str, SLO] = field(default_factory=dict)
    price: Price = Price()

    def __post_init__(self):
        if self.horizon_s <= 0 or self.windows < 1:
            raise ValueError("need horizon_s > 0 and windows >= 1")

    @property
    def window_s(self) -> float:
        return self.horizon_s / self.windows


@dataclass
class TenantGrade:
    """One tenant's verdicts for one scenario run."""
    tenant: str
    offered: int = 0
    served: int = 0
    rejected: int = 0
    goodput_rps: float = 0.0
    goodput_ratio: float = 1.0
    p99_ttft_s: float = 0.0
    p99_latency_s: float = 0.0
    verdicts: Dict[str, bool] = field(default_factory=dict)
    slo_pass: bool = True
    steps_lost: int = 0
    recoveries: int = 0
    makespan_s: float = 0.0
    chargeback: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant, "offered": self.offered,
            "served": self.served, "rejected": self.rejected,
            "goodput_rps": round(self.goodput_rps, 4),
            "goodput_ratio": round(self.goodput_ratio, 4),
            "p99_ttft_s": round(self.p99_ttft_s, 4),
            "p99_latency_s": round(self.p99_latency_s, 4),
            "verdicts": dict(self.verdicts), "slo_pass": self.slo_pass,
            "steps_lost": self.steps_lost, "recoveries": self.recoveries,
            "makespan_s": round(self.makespan_s, 3),
            "chargeback": {k: round(v, 6)
                           for k, v in self.chargeback.items()},
        }


def chargeback(price: Price, *, bytes_moved: float,
               device_s: float) -> Dict[str, float]:
    gb = bytes_moved / 1e9
    transfer_cost = gb * price.per_gb
    device_cost = device_s * price.per_device_s
    return {"gb_moved": gb, "transfer_cost": transfer_cost,
            "device_s": device_s, "device_cost": device_cost,
            "total": transfer_cost + device_cost}


def grade_tenant(tenant: str, slo: SLO, *, offered: int, served: int,
                 ttft_s: Sequence[float] = (),
                 latency_s: Sequence[float] = (),
                 horizon_s: float, price: Price = Price(),
                 bytes_moved: float = 0.0, device_s: float = 0.0,
                 steps_lost: int = 0, recoveries: int = 0,
                 makespan_s: float = 0.0) -> TenantGrade:
    """Grade one tenant.  ``offered``/``served`` count requests over the
    whole scenario; ``ttft_s``/``latency_s`` are the raw per-request
    samples (all waves concatenated)."""
    if served > offered:
        raise ValueError(f"served {served} > offered {offered}")
    g = TenantGrade(tenant=tenant, offered=offered, served=served,
                    rejected=offered - served,
                    steps_lost=steps_lost, recoveries=recoveries,
                    makespan_s=makespan_s)
    g.goodput_rps = served / horizon_s if horizon_s > 0 else 0.0
    g.goodput_ratio = served / offered if offered else 1.0
    g.p99_ttft_s = percentile(ttft_s, 99)
    g.p99_latency_s = percentile(latency_s, 99)
    if slo.p99_ttft_s is not None:
        g.verdicts["p99_ttft"] = g.p99_ttft_s <= slo.p99_ttft_s
    if slo.p99_latency_s is not None:
        g.verdicts["p99_latency"] = g.p99_latency_s <= slo.p99_latency_s
    if slo.min_goodput > 0:
        g.verdicts["goodput"] = g.goodput_ratio >= slo.min_goodput
    g.slo_pass = all(g.verdicts.values()) if g.verdicts else True
    g.chargeback = chargeback(price, bytes_moved=bytes_moved,
                              device_s=device_s)
    return g


def grade_table(grades: List[TenantGrade]) -> str:
    """The report card as markdown — one row per tenant."""
    head = ("| tenant | offered | served | goodput | p99 TTFT | p99 lat "
            "| SLO | steps lost | bill |")
    sep = "|---" * 9 + "|"
    rows = []
    for g in sorted(grades, key=lambda g: g.tenant):
        rows.append(
            f"| {g.tenant} | {g.offered} | {g.served} "
            f"| {g.goodput_ratio:.0%} | {g.p99_ttft_s * 1e3:.1f}ms "
            f"| {g.p99_latency_s * 1e3:.1f}ms "
            f"| {'PASS' if g.slo_pass else 'FAIL'} | {g.steps_lost} "
            f"| ${g.chargeback.get('total', 0.0):.4f} |")
    return "\n".join([head, sep] + rows)

"""The scenario driver — replay traffic, inject chaos, grade the run.

One ``run_scenario`` call is the paper's whole measurement loop: a
``ScenarioSpec`` splits the sim horizon into windows; each window's
slice of every tenant's ``TrafficShape`` trace is dispatched as one
ServeJob wave — a *manifest dict* applied through the tenant's
``Session``, so the scenario exercises the same declarative surface a
user would.  Training plans run across the whole horizon, burst plans
fire BatchJobs at their scheduled sim-times, and the ``ChaosInjector``
fires *after* a window's waves launch but before the driver waits on
them — so failures land mid-wave and the stack must actually survive
them (site-stranded waves requeue onto survivors, degraded links shift
placement), not merely between them.

Sim-time here is window-granular: window ``w`` spans sim
``[w, w+1) * spec.window_s`` regardless of how long the wave takes on
the wall clock.  That keeps the replay deterministic — the same spec,
shapes and schedule grade the same traffic against the same failures on
any machine speed.

A copy of the JAX package's ``scenarios/driver.py``: each wave's ServeJob
computes on the device of the site the tenant's scheduler placed it at.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.api.resources import from_manifest
from repro_torch.api.session import Session
from repro_torch.scenarios.chaos import ChaosInjector, ChaosSchedule
from repro_torch.scenarios.grade import (SLO, ScenarioSpec, TenantGrade,
                                         grade_tenant)
from repro_torch.scenarios.traffic import TrafficShape, slice_window
from repro_torch.serving.report import GAUGES


@dataclass
class ServePlan:
    """One serving tenant's scenario role: a traffic shape plus the base
    ServeJob manifest dict its waves are stamped from (the driver fills
    ``metadata.name`` and ``spec.requests`` per window)."""
    shape: TrafficShape
    manifest: Dict[str, Any]


@dataclass
class TrainPlan:
    """One training tenant's scenario role: a TrainJob manifest applied
    once, riding through the whole horizon (and all of its chaos)."""
    manifest: Dict[str, Any]


@dataclass
class BurstPlan:
    """Scheduled batch surges: the BatchJob manifest is applied (with
    the runtime ``fn``) at each sim-time in ``times`` — the
    high-priority interlopers that force fair-share preemption."""
    times: Sequence[float]
    manifest: Dict[str, Any]
    fn: Callable


@dataclass
class ScenarioResult:
    spec: ScenarioSpec
    grades: Dict[str, TenantGrade]
    chaos_fired: List[Dict[str, Any]]
    makespans: Dict[str, float]
    fairshare_skew: float
    wall_s: float
    waves: List[Dict[str, Any]] = field(default_factory=list)
    train_results: Dict[str, Any] = field(default_factory=dict)
    burst_states: List[str] = field(default_factory=list)

    def report(self) -> Dict[str, Any]:
        """The JSON-able run summary (what the SCENARIO_REPORT stdout line
        carries)."""
        return {
            "scenario": self.spec.name,
            "horizon_s": self.spec.horizon_s,
            "windows": self.spec.windows,
            "wall_s": round(self.wall_s, 3),
            "fairshare_skew": round(self.fairshare_skew, 4),
            "chaos": [{k: v for k, v in rec.items() if v is not None}
                      for rec in self.chaos_fired],
            "tenants": {t: g.to_json() for t, g in self.grades.items()},
        }


def _wave_manifest(plan: ServePlan, window: int,
                   requests: List[Dict]) -> Dict[str, Any]:
    m = copy.deepcopy(plan.manifest)
    m.setdefault("metadata", {})
    m["metadata"]["name"] = (f"{m['metadata'].get('name', plan.shape.name)}"
                             f"-w{window}")
    m.setdefault("spec", {})["requests"] = requests
    return m


def run_scenario(sched, spec: ScenarioSpec, *,
                 serve: Dict[str, ServePlan],
                 train: Optional[Dict[str, TrainPlan]] = None,
                 bursts: Optional[Dict[str, BurstPlan]] = None,
                 chaos: Optional[ChaosSchedule] = None,
                 wave_timeout_s: float = 600.0,
                 train_timeout_s: float = 600.0) -> ScenarioResult:
    """Drive one scenario against a running ``FairShareScheduler``
    (its reconcile loop must be live: ``sched.start()`` / ``with
    sched:``).  Keys of ``serve``/``train``/``bursts`` are tenant names
    already created on the scheduler."""
    train = train or {}
    bursts = bursts or {}
    tenants = sorted(set(serve) | set(train) | set(bursts))
    for t in tenants:
        if t not in sched.tenants:
            raise KeyError(f"scenario tenant {t!r} not on the scheduler")
    sessions = {t: Session(tenant=sched.tenants[t]) for t in tenants}
    injector = ChaosInjector(sched.fabric, chaos, bus=sched.bus) \
        if chaos is not None else None

    # pre-render every serve tenant's full trace once (deterministic)
    traces: Dict[str, List[Dict]] = {}
    for t, plan in serve.items():
        job = from_manifest(plan.manifest)     # validates the base manifest
        from repro_torch.api.runners import resolve_serve_cfg
        traces[t] = plan.shape.requests(
            spec.horizon_s, vocab_size=resolve_serve_cfg(job).vocab_size)

    t_start = time.monotonic()
    train_handles = {t: sessions[t].apply(plan.manifest)
                     for t, plan in train.items()}
    burst_handles: List[Any] = []

    offered = {t: 0 for t in tenants}
    served = {t: 0 for t in tenants}
    ttft: Dict[str, List[float]] = {t: [] for t in tenants}
    latency: Dict[str, List[float]] = {t: [] for t in tenants}
    serve_busy = {t: 0.0 for t in tenants}
    waves_log: List[Dict[str, Any]] = []

    for w in range(spec.windows):
        t0, t1 = w * spec.window_s, (w + 1) * spec.window_s
        if injector is not None:
            injector.fire_due(t0)
        # launch this window's waves and due bursts...
        wave_handles: Dict[str, Any] = {}
        wave_sizes: Dict[str, int] = {}
        wave_t0: Dict[str, float] = {}
        for t, plan in serve.items():
            reqs = slice_window(traces[t], t0, t1)
            if not reqs:
                continue
            offered[t] += len(reqs)
            wave_sizes[t] = len(reqs)
            wave_t0[t] = time.time()
            wave_handles[t] = sessions[t].apply(
                _wave_manifest(plan, w, reqs))
        for t, plan in bursts.items():
            for i, bt in enumerate(plan.times):
                if t0 <= bt < t1:
                    m = copy.deepcopy(plan.manifest)
                    m.setdefault("metadata", {})
                    m["metadata"]["name"] = \
                        f"{m['metadata'].get('name', 'burst')}-{i}"
                    burst_handles.append(
                        sessions[t].apply(m, fn=plan.fn))
        # ...then the window's chaos, so failures land MID-wave
        if injector is not None:
            injector.fire_due(t1)
        for t, h in wave_handles.items():
            ok, n_ok = True, 0
            try:
                out = h.wait(wave_timeout_s)
            except TimeoutError:
                h.cancel(wait=True, timeout=30.0)
                out, ok = h.result(), False
            except RuntimeError:
                out, ok = None, False      # wave FAILED => all rejected
            if isinstance(out, dict):
                n_ok = len(out.get("results") or {})
                m = out.get("metrics")
                if m is not None:
                    ttft[t] += [v for _, v in
                                m.series(GAUGES.TTFT_S).snapshot()]
                    latency[t] += [v for _, v in
                                   m.series(GAUGES.LATENCY_S).snapshot()]
            served[t] += min(n_ok, wave_sizes[t])
            # each wave's span runs from ITS OWN apply to ITS terminal
            # transition (the handle's last lifecycle event) — waves of
            # one window run concurrently, so timing them from this wait
            # loop would bill the first-waited tenant for every
            # co-tenant's wall time
            end_ts = (h.events() or [{}])[-1].get("ts", time.time())
            serve_busy[t] += max(0.0, end_ts - wave_t0[t])
            waves_log.append({"window": w, "tenant": t,
                              "offered": wave_sizes[t], "served": n_ok,
                              "ok": ok})

    if injector is not None:       # trailing restores past the last window
        injector.fire_due(spec.horizon_s + 1e9)
    burst_states = []
    for h in burst_handles:
        try:
            h.wait(wave_timeout_s)
        except (TimeoutError, RuntimeError):
            pass
        burst_states.append(h.state.value)
    train_reports: Dict[str, Any] = {}
    train_results: Dict[str, Any] = {}
    for t, h in train_handles.items():
        out = h.wait(train_timeout_s)
        train_results[t] = out
        train_reports[t] = out.get("report") if isinstance(out, dict) \
            else None
    wall_s = time.monotonic() - t_start

    makespans: Dict[str, float] = {}
    grades: Dict[str, TenantGrade] = {}
    for t in tenants:
        rep = train_reports.get(t)
        makespans[t] = getattr(rep, "total_wall_s", 0.0) or serve_busy[t]
        grades[t] = grade_tenant(
            t, spec.slos.get(t, SLO()),
            offered=offered[t], served=served[t],
            ttft_s=ttft[t], latency_s=latency[t],
            horizon_s=spec.horizon_s, price=spec.price,
            bytes_moved=sched.metrics.series(
                f"fabric/tenant/{t}/bytes_moved").total,
            device_s=sched.metrics.series(
                f"lease_device_s/tenant-{t}").total,
            steps_lost=getattr(rep, "steps_lost", 0),
            recoveries=getattr(rep, "recoveries", 0),
            makespan_s=makespans[t])

    busy = [serve_busy[t] for t in serve if offered[t] > 0]
    skew = (max(busy) / max(min(busy), 1e-9)) if len(busy) > 1 else 1.0
    return ScenarioResult(
        spec=spec, grades=grades,
        chaos_fired=injector.fired if injector is not None else [],
        makespans=makespans, fairshare_skew=skew, wall_s=wall_s,
        waves=waves_log, train_results=train_results,
        burst_states=burst_states)

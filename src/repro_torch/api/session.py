"""Session — one manifest-driven control plane for every workload kind.

The paper's users never drive subsystems by hand: they declare a
workload and the platform schedules, places, measures and heals it
(§II, §VI).  ``Session`` is that surface here.  Construct it over a
cluster —

    Session(cluster=Cluster())                          # the card(s)
    Session(cluster=Cluster(devices=[torch.device("cpu")]))

— then drive every workload kind with one verb set:

    handle = session.apply(TrainJob(name="t", steps=20))   # or a manifest
    handle.status()        # observed state (phase + live probes)
    handle.wait()          # block for the result
    handle.events()        # the lifecycle stream so far
    handle.cancel()        # cooperative drain -> CANCELLED

Each ``Handle`` owns a desired->observed reconcile loop in a background
thread: the workload moves PENDING -> PLACING -> RUNNING -> one of
{SUCCEEDED, FAILED, PREEMPTED, CANCELLED}, every transition is recorded
on the handle AND published to the session's ``EventBus`` (kind
``"workload"``), so a monitor renders train / serve / batch / workflow
workloads uniformly.  ``cancel()`` reuses the platform's cooperative
drain primitives (``Cluster.preempt_pod``, the serving engine's
``should_stop``, the workflow's step boundary), so a cancelled training
job keeps its checkpoint.

A copy of the JAX package's ``api/session.py`` with the cluster and the
fabric backends: the tenant backend waits for the port of the
multi-tenant scheduler (ROADMAP A8), and asking for it raises
``NotImplementedError``.  Workloads run on their cluster's compute
device; nothing moves to the CPU unless that device is the CPU.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Mapping, Optional

from repro_torch.api.resources import (BatchJob, ManifestError, RLJob,
                                       ServeJob, TrainJob, WorkflowRun,
                                       WorkloadSpec, from_manifest,
                                       load_manifest)


class WorkloadState(str, Enum):
    PENDING = "Pending"        # applied, reconcile loop not yet placing
    PLACING = "Placing"        # resolving configs / choosing a site
    RUNNING = "Running"        # the subsystem is executing the workload
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    PREEMPTED = "Preempted"    # evicted by the platform, not by the user
    CANCELLED = "Cancelled"    # user-requested cooperative drain finished


TERMINAL_STATES = (WorkloadState.SUCCEEDED, WorkloadState.FAILED,
                   WorkloadState.PREEMPTED, WorkloadState.CANCELLED)


@dataclass
class WorkloadStatus:
    """One observed snapshot of a workload."""
    name: str
    kind: str
    backend: str
    state: WorkloadState
    error: Optional[str] = None
    observed: Dict[str, Any] = field(default_factory=dict)

    def brief(self) -> str:
        obs = " ".join(f"{k}={v}" for k, v in self.observed.items())
        return (f"{self.kind:<12} {self.name:<20} {self.state.value:<10} "
                f"{obs}").rstrip()


class Handle:
    """The live handle on one applied workload (see module docstring)."""

    def __init__(self, spec: WorkloadSpec, backend: str, bus=None):
        self.spec = spec
        self.backend = backend
        self._bus = bus
        self._lock = threading.Lock()
        self._state = WorkloadState.PENDING
        self._result: Any = None
        self._error: Optional[str] = None
        self._events: List[Dict[str, Any]] = []
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._cancel = threading.Event()
        self._cancel_hooks: List[Callable[[], None]] = []
        self._done = threading.Event()
        self._final_override: Optional[WorkloadState] = None
        self._thread: Optional[threading.Thread] = None
        self._record(self._state)

    # ----------------------------------------------------------- lifecycle
    def _record(self, state: WorkloadState, **detail) -> None:
        ev = {"ts": time.time(), "state": state.value, **detail}
        self._events.append(ev)
        if self._bus is not None:
            self._bus.publish("workload", source=self.spec.name,
                              resource=self.spec.KIND,
                              backend=self.backend, state=state.value,
                              **detail)

    def _transition(self, state: WorkloadState, **detail) -> None:
        with self._lock:
            if self._state in TERMINAL_STATES:
                return
            self._state = state
            self._record(state, **detail)
        if state in TERMINAL_STATES:
            self._done.set()

    def _finish(self, state: WorkloadState, *, result: Any = None,
                error: Optional[str] = None) -> None:
        with self._lock:
            if self._state in TERMINAL_STATES:
                return
            self._result = result
            self._error = error
            self._state = state
            self._record(state, **({"error": error.splitlines()[0]}
                                   if error else {}))
        self._done.set()

    def _set_final(self, state: WorkloadState) -> None:
        """A runner observed a platform-driven terminal outcome (e.g. the
        job was preempted and will not be resubmitted)."""
        self._final_override = state

    # ---------------------------------------------------------- the verbs
    @property
    def state(self) -> WorkloadState:
        with self._lock:
            return self._state

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def should_stop(self) -> bool:
        """The cooperative drain signal runners thread into subsystems."""
        return self._cancel.is_set()

    def status(self) -> WorkloadStatus:
        observed = {}
        for name, probe in list(self._probes.items()):
            try:
                observed[name] = probe()
            except Exception:       # a probe must never break status()
                pass
        with self._lock:
            return WorkloadStatus(name=self.spec.name, kind=self.spec.KIND,
                                  backend=self.backend, state=self._state,
                                  error=self._error, observed=observed)

    def wait(self, timeout: float = 600.0) -> Any:
        """Block until terminal.  Returns the result (partial results for
        CANCELLED / PREEMPTED); raises for FAILED."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"workload {self.spec.name!r} ({self.state.value}) "
                f"not terminal within {timeout}s")
        if self.state == WorkloadState.FAILED:
            raise RuntimeError(
                f"workload {self.spec.name!r} failed: {self._error}")
        return self._result

    def result(self) -> Any:
        return self._result

    def events(self) -> List[Dict[str, Any]]:
        """The recorded lifecycle transitions (oldest first)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def cancel(self, *, wait: bool = False, timeout: float = 600.0) -> bool:
        """Request a cooperative drain.  Training checkpoints and exits,
        serving stops between fused decode steps, batch pods get the
        preempt signal, workflows stop at the next step boundary.
        Returns False when the workload is already terminal."""
        with self._lock:
            if self._state in TERMINAL_STATES:
                return False
            self._cancel.set()
            self._record(self._state, event="cancel-requested")
        for hook in list(self._cancel_hooks):
            try:
                hook()
            except Exception:
                pass
        if wait:
            self._done.wait(timeout)
        return True

    # ------------------------------------------------------- runner wiring
    def add_cancel_hook(self, hook: Callable[[], None]) -> None:
        self._cancel_hooks.append(hook)
        if self._cancel.is_set():       # cancel() already ran: fire now
            try:
                hook()
            except Exception:
                pass

    def probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Expose a live observed value (e.g. the trainer's step) through
        ``status()`` without leaking the subsystem object."""
        self._probes[name] = fn

    def _launch(self, run_fn: Callable[["Handle"], Any]) -> "Handle":
        def loop():
            try:
                if self.cancel_requested:
                    self._finish(WorkloadState.CANCELLED)
                    return
                result = run_fn(self)
            except Exception as e:
                if self.cancel_requested:
                    self._finish(WorkloadState.CANCELLED, error=str(e))
                else:
                    self._finish(WorkloadState.FAILED,
                                 error=f"{e}\n{traceback.format_exc()}")
            else:
                if self.cancel_requested:
                    self._finish(WorkloadState.CANCELLED, result=result)
                elif self._final_override is not None:
                    self._finish(self._final_override, result=result)
                else:
                    self._finish(WorkloadState.SUCCEEDED, result=result)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"api-{self.spec.name}")
        self._thread.start()
        return self


class Session:
    """The unified control plane over one backend (see module docstring).

    Exactly one backend must be given:

    ``cluster``
        A bare ``repro_torch.core.orchestrator.Cluster`` (plus an
        optional ``store`` for checkpoints / workflow state).
    ``fabric`` / ``planner``
        The multi-site federation.  A ``planner``
        (``repro_torch.fabric.PlacementPlanner``) enables placed
        workflows and cross-site failover; a bare fabric routes by queue
        depth.
    ``tenant``
        The JAX package's tenant fair share: not ported yet (ROADMAP
        A8), so it raises ``NotImplementedError``.
    """

    def __init__(self, *, cluster=None, store=None, fabric=None,
                 planner=None, tenant=None, metrics=None, bus=None,
                 namespace: Optional[str] = None):
        from repro_torch.api import runners
        backends = [b for b in
                    ("cluster" if cluster is not None else None,
                     "fabric" if (fabric is not None or planner is not None)
                     else None,
                     "tenant" if tenant is not None else None)
                    if b is not None]
        if len(backends) != 1:
            raise TypeError(
                "Session needs exactly one backend: cluster=..., "
                f"fabric=.../planner=..., or tenant=... (got {backends})")
        if tenant is not None:
            raise NotImplementedError(
                "Session(tenant=...): the port has the cluster and fabric "
                "backends; the tenant backend waits for ROADMAP A8")
        self.namespace = namespace
        self.workloads: List[Handle] = []
        if cluster is not None:
            self.metrics = metrics or cluster.metrics
            self.bus = bus or self._own_bus(cluster=cluster)
            self._backend = runners.ClusterBackend(self, cluster, store)
        else:
            fabric = fabric if fabric is not None else planner.fabric
            self.metrics = metrics or fabric.metrics
            self.bus = bus or self._own_bus(fabric=fabric)
            self._backend = runners.FabricBackend(self, fabric, planner,
                                                  store)

    def _own_bus(self, cluster=None, fabric=None):
        from repro_torch.vcluster.monitor import EventBus
        bus = EventBus(metrics=self.metrics)
        if cluster is not None:
            bus.attach_cluster(cluster)
        if fabric is not None:
            bus.attach_fabric(fabric)
        return bus

    # -------------------------------------------------------------- verbs
    def apply(self, spec, **runtime) -> Handle:
        """Apply one workload spec (or manifest dict) and return its
        Handle.  ``runtime`` attaches runtime-only fields that cannot
        ride in a manifest: ``fn=`` (BatchJob), ``define=``
        (WorkflowRun)."""
        if isinstance(spec, Mapping):
            spec = from_manifest(spec)
        if runtime:
            import dataclasses
            spec = dataclasses.replace(spec, **runtime)
        runner = {
            TrainJob: self._backend.run_train,
            ServeJob: self._backend.run_serve,
            BatchJob: self._backend.run_batch,
            WorkflowRun: self._backend.run_workflow,
            RLJob: self._backend.run_rl,
        }.get(type(spec))
        if runner is None:
            raise ManifestError(
                f"Session.apply got {type(spec).__name__}; expected one "
                f"of TrainJob/ServeJob/BatchJob/WorkflowRun/RLJob or a "
                f"manifest")
        handle = Handle(spec, self._backend.kind, bus=self.bus)
        self.workloads.append(handle)
        return handle._launch(lambda h: runner(h, spec))

    def apply_manifest(self, path: str, **runtime) -> Handle:
        """``apply`` for a manifest file on disk (the kubectl path)."""
        return self.apply(load_manifest(path), **runtime)

    def forget(self, handle: Handle) -> None:
        """Drop a terminal workload from this session and the result its
        handle holds (a TrainJob's params, a ServeJob's outputs), so that
        a long-lived session does not pin them on the device.  The handle
        keeps its state and events."""
        if handle.state not in TERMINAL_STATES:
            raise ValueError(f"workload {handle.spec.name!r} is "
                             f"{handle.state.value}: wait or cancel first")
        self.workloads.remove(handle)
        handle._result = None

    def status(self) -> List[WorkloadStatus]:
        """Observed state of every workload applied on this session."""
        return [h.status() for h in self.workloads]

    def wait(self, timeout: float = 600.0) -> List[Any]:
        """Block until every applied workload is terminal; returns their
        results in apply order (raises on the first FAILED one)."""
        return [h.wait(timeout) for h in self.workloads]

    def events(self) -> List[Dict[str, Any]]:
        """Every workload's lifecycle events, merged, oldest first."""
        out: List[Dict[str, Any]] = []
        for h in self.workloads:
            for e in h.events():
                out.append({"workload": h.spec.name, **e})
        return sorted(out, key=lambda e: e["ts"])

    def cancel(self, *, wait: bool = False, timeout: float = 600.0) -> int:
        """Cancel every non-terminal workload; returns how many."""
        return sum(1 for h in self.workloads
                   if h.cancel(wait=wait, timeout=timeout))

"""Workflow engine — the paper's step-by-step, measured, resumable workflows.

CHASE-CI's CONNECT workflow (§III) is four steps (download -> train ->
distributed inference -> visualization), each a Kubernetes Job that is
independently testable, measured in Grafana, and restartable.  The PPoDS
methodology (§VI) demands: separable steps, per-step measurement, and
development of steps in isolation.

Here a ``Workflow`` is a DAG of ``Step``s executed on a ``Cluster``:
  * each step runs as an orchestrator Job (pods = threads, devices = mesh
    slices) and its wall-time / bytes / resource footprint is recorded as a
    StepReport — Table I of the paper falls out of ``wf.table_one()``;
  * steps persist a completion marker + output manifest to the ObjectStore
    (the Ceph analogue), so a crashed / restarted workflow resumes from the
    last completed step (fault tolerance at the workflow level, on top of
    the queue's at-least-once and the checkpointer's auto-resume);
  * ``only=`` runs a single step in isolation (PPoDS independent testing).

Federated mode (paper §IV, ``repro_torch.fabric``): construct the workflow with
a ``planner`` instead of a fixed cluster/store, and annotate steps with
the dataset keys they consume/produce (``inputs=``/``outputs=``).  Every
step is then *placed*: the planner scores each live site by the simulated
cost of moving the step's missing input bytes plus its queue depth, picks
a site, pre-stages missing inputs over the bandwidth-modeled links, and
runs the step on that site's cluster against that site's store view.  The
step report gains ``site``, ``bytes_moved`` and ``transfer_s`` columns.

A copy of the JAX package's ``core/workflow.py``.  Markers and output
manifests are written to the same keys with the same bytes, so a
workflow started by either stack resumes under the other.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.metrics import Registry, StepReport, table_one
from repro_torch.core.orchestrator import Cluster, JobSpec
from repro_torch.data.objectstore import ObjectStore


@dataclass
class StepCtx:
    """What a step's fn receives."""
    cluster: Cluster
    store: ObjectStore
    metrics: Registry
    namespace: str
    inputs: Dict[str, Any]          # outputs of dependency steps
    report: StepReport              # fill in data_processed / memory etc.


@dataclass
class Step:
    name: str
    fn: Callable[[StepCtx], Any]
    deps: Sequence[str] = ()
    pods: int = 1
    devices_per_pod: int = 0
    # dataset keys this step reads/writes in the (federated) store; the
    # placement planner scores sites by where `inputs` replicas live.  An
    # entry "prefix/*" globs every cataloged key under the prefix.
    inputs: Sequence[str] = ()
    outputs: Sequence[str] = ()

    def marker_key(self, wf: str) -> str:
        return f"workflows/{wf}/{self.name}/_COMPLETE"

    def output_key(self, wf: str) -> str:
        return f"workflows/{wf}/{self.name}/output.json"


class Workflow:
    def __init__(self, name: str, *, cluster: Optional[Cluster] = None,
                 store: Optional[ObjectStore] = None,
                 metrics: Optional[Registry] = None,
                 namespace: str = "default", planner=None, bus=None):
        """Single-cluster mode needs ``cluster`` + ``store``; federated
        mode needs a ``repro_torch.fabric.PlacementPlanner`` and places each
        step on the fabric instead.  ``bus`` (a
        ``repro_torch.vcluster.monitor.EventBus``) streams per-step lifecycle
        events — placed / done / skipped — to live subscribers."""
        self.name = name
        self.planner = planner
        self.bus = bus
        if planner is None and (cluster is None or store is None):
            raise TypeError("Workflow needs cluster+store, or a planner")
        self.cluster = cluster
        self.store = store
        self.metrics = metrics or (cluster.metrics if cluster is not None
                                   else planner.fabric.metrics)
        self.namespace = namespace
        if cluster is not None and namespace not in cluster.namespaces:
            cluster.create_namespace(namespace)
        self.steps: Dict[str, Step] = {}
        self.reports: List[StepReport] = []
        self.results: Dict[str, Any] = {}
        # the graph executor (flow) runs steps from a worker pool:
        # shared mutable state appends under _lock, placement decisions
        # serialize under _place_lock (the planner's scoring + its
        # round-robin cursor are cheap; the staging transfers they
        # trigger still overlap)
        self._lock = threading.RLock()
        self._place_lock = threading.Lock()

    # control-plane reads/writes work in both modes: a plain ObjectStore,
    # or the federated catalog (whole-namespace view)
    def _ctrl(self):
        return self.store if self.store is not None else self.planner.fed

    # ------------------------------------------------------------------ DAG
    def add(self, step: Step) -> "Workflow":
        if step.name in self.steps:
            raise ValueError(f"duplicate step {step.name}")
        self.steps[step.name] = step
        return self

    def step(self, name: str, deps: Sequence[str] = (), pods: int = 1,
             devices_per_pod: int = 0, inputs: Sequence[str] = (),
             outputs: Sequence[str] = ()):
        """Decorator form: @wf.step("train", deps=["download"])"""
        def deco(fn):
            self.add(Step(name, fn, deps, pods, devices_per_pod,
                          inputs, outputs))
            return fn
        return deco

    def _topo_order(self) -> List[Step]:
        order, seen, visiting = [], set(), set()

        def visit(name: str):
            if name in seen:
                return
            if name in visiting:
                raise ValueError(f"cycle at {name}")
            visiting.add(name)
            for d in self.steps[name].deps:
                visit(d)
            visiting.discard(name)
            seen.add(name)
            order.append(self.steps[name])

        for name in self.steps:
            visit(name)
        return order

    # ------------------------------------------------------------------ run
    def run(self, *, resume: bool = True, only: Optional[str] = None,
            should_stop=None) -> Dict:
        """Run the DAG.  ``should_stop`` (a zero-arg callable, e.g. a
        ``repro_torch.api`` Handle's cancel signal) is polled at every step
        boundary: when it goes true the workflow stops cleanly — steps
        already completed keep their markers, so a later ``run`` resumes
        from exactly here.  The cancel is reported as one workflow-level
        ``cancelled`` event plus a ``skipped(reason=cancelled)`` step
        event for EVERY step that will not run — downstream steps that
        were never reached included."""
        order = self._topo_order()
        for i, step in enumerate(order):
            if should_stop is not None and should_stop():
                remaining = [s.name for s in order[i:]
                             if only is None or s.name == only]
                self._emit_workflow("cancelled", remaining=len(remaining))
                for name in remaining:
                    self._emit(name, "skipped", reason="cancelled")
                break
            if only is not None and step.name != only:
                # still load completed deps' outputs for the isolated step
                if self._ctrl().exists(step.marker_key(self.name)):
                    self.results[step.name] = self._load_output(step)
                continue
            self._run_step(step, resume)
        return dict(self.results)

    def _load_output(self, step: Step):
        """A completed step's stored output manifest.  The marker alone
        does not prove the manifest survived (a partially-synced or
        hand-pruned store): missing/corrupt outputs fail HERE, naming
        the step, not as a KeyError inside a downstream consumer."""
        key = step.output_key(self.name)
        ctrl = self._ctrl()
        if not ctrl.exists(key):
            raise RuntimeError(
                f"workflow {self.name!r}: step {step.name!r} has a "
                f"completion marker but its output manifest {key!r} is "
                f"missing from the store; re-run with resume=False (or "
                f"wf.reset()) to re-execute it")
        try:
            return json.loads(ctrl.get(key))
        except (ValueError, OSError) as e:
            raise RuntimeError(
                f"workflow {self.name!r}: step {step.name!r} output "
                f"manifest {key!r} is unreadable ({e}); re-run with "
                f"resume=False to re-execute it") from e

    def _place(self, step: Step):
        """Federated mode: choose the step's site, pre-stage its missing
        inputs, and return (cluster, store_view, placement, staged
        (bytes, sim_s)).  Scoring serializes under ``_place_lock`` (the
        planner's round-robin cursor and queue-depth reads are not
        atomic); the staging transfers themselves overlap freely."""
        with self._place_lock:
            placement = self.planner.place(
                step.inputs,
                devices=step.devices_per_pod * max(1, step.pods))
        site = self.planner.fabric.sites[placement.site]
        with self._lock:
            if self.namespace not in site.cluster.namespaces:
                site.cluster.create_namespace(self.namespace)
        staged = self.planner.prestage(step.inputs, placement.site)
        # reserve the slot so CONCURRENT placements (flow branches,
        # which run pods=1 fns inline and never show up in queue_depth)
        # see this site as loaded; _exec_step releases it when done
        self.planner.reserve(placement.site)
        return (site.cluster, self.planner.fed.view(placement.site),
                placement, staged)

    def _emit(self, step: str, status: str, *, kind: str = "step",
              **data) -> None:
        if self.bus is not None:
            self.bus.publish(kind, source=self.name, step=step,
                             status=status, **data)

    def _emit_workflow(self, status: str, **data) -> None:
        """A workflow-level lifecycle event (kind ``workflow``)."""
        if self.bus is not None:
            self.bus.publish("workflow", source=self.name, status=status,
                             **data)

    def _run_step(self, step: Step, resume: bool) -> None:
        for d in step.deps:
            if d not in self.results:
                raise RuntimeError(
                    f"workflow {self.name!r}: step {step.name!r} depends "
                    f"on {d!r}, which has not completed (running with "
                    f"only={step.name!r}? run the dependency first)")
        out, _ = self._exec_step(
            step, {d: self.results[d] for d in step.deps}, resume)
        self.results[step.name] = out

    def _exec_step(self, step: Step, inputs: Dict[str, Any],
                   resume: bool, *, emit_kind: str = "step",
                   concurrent: bool = False,
                   **emit_extra) -> Tuple[Any, bool]:
        """Execute ONE step against explicit ``inputs`` and return
        ``(output, skipped)``.  This is the unit both executors share:
        the serial ``run`` loop above, and the concurrent graph executor
        (``repro_torch.flow``), which calls it from pool threads —
        ``concurrent=True`` attributes data movement from the step's own
        staging result instead of fabric-meter deltas (globals deltas
        would cross-count parallel steps' transfers)."""
        marker = step.marker_key(self.name)
        if resume and self._ctrl().exists(marker):
            out = self._load_output(step)
            self.metrics.inc(f"workflow/{self.name}/{step.name}/skipped")
            self._emit(step.name, "skipped", kind=emit_kind, **emit_extra)
            return out, True

        report = StepReport(step=step.name, pods=step.pods,
                            cpus=step.pods,
                            devices=step.pods * step.devices_per_pod)
        staged = (0, 0.0)
        if self.planner is not None:
            # snapshot the FABRIC meters (not self.metrics, which a caller
            # may have overridden) so pre-staging AND any on-demand
            # pull-through reads inside the step are attributed to it
            fmetrics = self.planner.fabric.metrics
            if not concurrent:
                moved0 = fmetrics.series("fabric/bytes_moved").total
                sim0 = fmetrics.series("fabric/transfer_s").total
            cluster, store, placement, staged = self._place(step)
            report.site = placement.site
            if placement.migrated:
                report.extra["migrated"] = 1.0
                fmetrics.inc("fabric/migrations")
        else:
            cluster, store, placement = self.cluster, self.store, None
        self._emit(step.name, "placed", kind=emit_kind,
                   site=placement.site if placement else "local",
                   mode=placement.mode if placement else "local",
                   **emit_extra)
        ctx = StepCtx(cluster=cluster, store=store,
                      metrics=self.metrics, namespace=self.namespace,
                      inputs=inputs, report=report)
        t0 = time.perf_counter()
        try:
            with self.metrics.timer(
                    f"workflow/{self.name}/{step.name}/time_s"):
                if step.pods <= 1:
                    out = step.fn(ctx)
                else:
                    # gang of pods; the step fn coordinates via a WorkQueue
                    job = cluster.submit(self.namespace, JobSpec(
                        name=f"{self.name}-{step.name}",
                        fn=lambda pc: step.fn(ctx),
                        replicas=1, devices_per_pod=step.devices_per_pod))
                    cluster.wait(job)
                    out = job.results()[0]
        finally:
            if placement is not None:
                self.planner.release(placement.site)
        report.total_time_s = time.perf_counter() - t0

        store.put(step.output_key(self.name),
                  json.dumps(out, default=str).encode())
        store.put(marker, b"ok")
        if self.planner is not None:
            # control-plane metadata (markers + output manifests, a few
            # bytes) is replicated to every live site, like Ceph metadata:
            # a later site loss must not un-complete finished steps.
            # Batched per site: one link latency, not one per key.
            ctrl_keys = [step.output_key(self.name), marker]
            for s in self.planner.fabric.up_sites():
                if s.name != placement.site:
                    self.planner.fed.replicate_many(ctrl_keys, s.name)
            for key in self.planner.expand(step.outputs):
                if not self.planner.fed.exists(key):   # declared, not written
                    self.metrics.inc(f"workflow/{self.name}/{step.name}"
                                     f"/missing_output")
            if concurrent:
                report.extra["bytes_moved"] = float(staged[0])
                report.extra["transfer_s"] = float(staged[1])
            else:
                report.extra["bytes_moved"] = \
                    fmetrics.series("fabric/bytes_moved").total - moved0
                report.extra["transfer_s"] = \
                    fmetrics.series("fabric/transfer_s").total - sim0
        with self._lock:
            self.reports.append(report)
        self._emit(step.name, "done", kind=emit_kind,
                   site=report.site or "local",
                   seconds=round(report.total_time_s, 4),
                   bytes_moved=int(report.extra.get("bytes_moved", 0)),
                   **emit_extra)
        return out, False

    # ------------------------------------------------------------- reporting
    def table_one(self) -> str:
        """The paper's Table I for this workflow."""
        return table_one(self.reports)

    def reset(self) -> None:
        for step in self.steps.values():
            for key in (step.marker_key(self.name), step.output_key(self.name)):
                self._ctrl().delete(key)
        self.results.clear()
        self.reports.clear()

"""Cluster / Namespace / Job / Pod — the Kubernetes constructs of CHASE-CI
(§II-A, §IV, §V) over a list of devices.

A copy of the JAX package's ``core/orchestrator.py``.  The default
device list differs: the card's CUDA devices (raising without a card)
where JAX took ``jax.devices()``.  Tests and the federation pass logical slots
(``devices=[0, 1, ...]``): the orchestrator only leases names.  Work
computes on ``Cluster.compute_device``: the ``compute`` device a cluster
of logical slots was built with (a fabric site's), else its first online
CUDA or CPU device.  A cluster built with ``ranks=`` declares its slots
ranks: the elastic trainer runs a segment as one process a leased slot.

Kubernetes semantics reproduced:
  * declarative jobs: you specify *what* (replicas, work), the controller
    reconciles actual state — crashed pods are respawned (backoff-limited),
    exactly like the paper's "Kubernetes will monitor these jobs which in
    themselves create and run pods ... re-spawn them if any errors occur";
  * namespaces: virtual sub-clusters with device quotas and isolation —
    two namespaces share hardware but not scheduling headroom (§IV);
  * device leases: a pod owns its devices from allocation until it reaches
    a terminal state; two live pods can never hold the same device, and a
    finished (or drained) pod returns quota to its namespace;
  * nodes joining/leaving: a NodeFailure drains the pods running on the
    failed device — they go FAILED, their leases are released, and the
    reconciler reschedules them onto fresh devices (§V), which pairs with
    checkpoint auto-resume (``repro_torch.checkpoint``);
  * preemption: ``preempt_pod`` is the checkpoint-then-evict drain the
    fair-share scheduler (``repro_torch.vcluster``) uses — cooperative
    like a node drain, but the pod is EXPECTED to save state
    on the way out, lands in the terminal PREEMPTED state, and is never
    respawned by the reconciler (whoever preempted it owns resubmission).

Pods run python callables in threads (one host).  Threads cannot be
killed, so a drain sets ``PodCtx.stop`` — long-running pod fns (e.g. the
elastic trainer's segments) poll it to exit cooperatively; the pod's
*state* flips to FAILED immediately either way.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.metrics import Registry
from repro_torch.device import resolve_device


class PodState(str, Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    # evicted by ``Cluster.preempt_pod``: terminal like FAILED, but the
    # reconciler never respawns it — whoever preempted it owns the
    # resubmission (the pod checkpointed before exiting)
    PREEMPTED = "Preempted"


TERMINAL_STATES = (PodState.SUCCEEDED, PodState.FAILED, PodState.PREEMPTED)


@dataclass
class Namespace:
    name: str
    device_quota: int
    labels: Dict[str, str] = field(default_factory=dict)
    used_devices: int = 0


@dataclass
class PodCtx:
    pod_id: str
    namespace: str
    devices: List[Any]
    metrics: Registry
    attempt: int = 0
    site: str = "local"       # which federation site's cluster runs this pod
    stop: threading.Event = field(default_factory=threading.Event)
    # graceful eviction (fair-share preemption): unlike ``stop`` — whose
    # node is gone — the hardware is healthy, so the pod is expected to
    # checkpoint before exiting (checkpoint-then-evict)
    preempt: threading.Event = field(default_factory=threading.Event)

    def should_stop(self) -> bool:
        """Cooperative drain signal (set on NodeFailure / preemption)."""
        return self.stop.is_set() or self.preempt.is_set()


@dataclass
class Pod:
    pod_id: str
    fn: Callable[[PodCtx], Any]
    ctx: PodCtx
    state: PodState = PodState.PENDING
    restarts: int = 0
    result: Any = None
    error: Optional[str] = None
    thread: Optional[threading.Thread] = None
    # internal bookkeeping: `gen` fences stale run() threads after a drain +
    # respawn; `holds_devices` makes lease release idempotent.
    gen: int = 0
    holds_devices: bool = False
    lease_t0: float = 0.0        # when the current device lease started


@dataclass
class JobSpec:
    name: str
    fn: Callable[[PodCtx], Any]          # each pod replica runs this
    replicas: int = 1
    devices_per_pod: int = 0             # 0 = CPU-only pod (e.g. download)
    backoff_limit: int = 3
    # scheduling priority (``repro_torch.vcluster``): higher may preempt
    # strictly lower.  None inherits the submitting tenant's priority.
    priority: Optional[int] = None


class Job:
    def __init__(self, spec: JobSpec, namespace: str):
        self.spec = spec
        self.namespace = namespace
        self.pods: List[Pod] = []

    @property
    def succeeded(self) -> bool:
        return (len(self.pods) == self.spec.replicas and
                all(p.state == PodState.SUCCEEDED for p in self.pods))

    @property
    def failed(self) -> bool:
        return any(p.state == PodState.FAILED and
                   p.restarts >= self.spec.backoff_limit for p in self.pods)

    @property
    def terminal(self) -> bool:
        """Every pod reached a terminal state (no thread is still live)."""
        return (len(self.pods) == self.spec.replicas and
                all(p.state in TERMINAL_STATES for p in self.pods))

    @property
    def preempted(self) -> bool:
        return any(p.state == PodState.PREEMPTED for p in self.pods)

    def results(self) -> List[Any]:
        return [p.result for p in self.pods]


class Cluster:
    """A set of devices ("nodes") + Kubernetes-style controller loop.

    ``site`` tags the cluster (and every pod it schedules) with the
    federation site that owns it — one PRP appliance in the paper's terms.
    A standalone cluster is the degenerate single-site case ("local");
    ``repro_torch.fabric`` wires many site-tagged clusters into one
    fabric.  ``compute`` is where a cluster of logical slots computes.
    ``ranks`` declares the slots ranks: an elastic training segment then
    runs one process a leased slot on the plan's mesh (True: each slot's
    own device where it names one, else the CPU, or card r for rank r;
    or a mapping naming each slot's device, e.g. several slots on
    ``"cuda:0"``); False trains on ``compute_device`` alone.
    """

    def __init__(self, devices: Optional[List[Any]] = None,
                 metrics: Optional[Registry] = None, site: str = "local",
                 compute=None, ranks: Any = False):
        if devices is None:
            resolve_device("cuda")          # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.site = site
        self.compute = None if compute is None else resolve_device(compute)
        self.ranks = ranks
        self._lock = threading.Lock()
        self.devices = list(devices)
        self.offline: set = set()
        self.leased: set = set()
        self.namespaces: Dict[str, Namespace] = {}
        self.jobs: List[Job] = []
        self.metrics = metrics or Registry()
        self._watchers: List[Callable[[str, Any], None]] = []
        self._pod_watchers: List[Callable[[str, Pod], None]] = []

    # ------------------------------------------------------------ namespaces
    def create_namespace(self, name: str, device_quota: Optional[int] = None,
                         **labels) -> Namespace:
        with self._lock:
            if name in self.namespaces:
                raise ValueError(f"namespace {name!r} exists")
            q = len(self.devices) if device_quota is None else device_quota
            ns = Namespace(name, q, labels)
            self.namespaces[name] = ns
            return ns

    def set_quota(self, namespace: str, device_quota: int) -> None:
        """Adjust a namespace's device quota (the fair-share scheduler's
        per-tenant accounting knob).  May drop below current usage: live
        leases are honored, only future allocations are blocked."""
        with self._lock:
            self.namespaces[namespace].device_quota = device_quota

    def free_devices(self) -> int:
        """Online devices not leased to any live pod."""
        with self._lock:
            return sum(1 for d in self.devices
                       if d not in self.offline and d not in self.leased)

    def _allocate_locked(self, ns: Namespace, n: int) -> List[Any]:
        """Lease `n` devices to a pod.  Caller holds self._lock.

        Devices already leased to a live pod are excluded — the seed's
        ``avail[:n]`` handed the same devices to every concurrent pod.
        """
        avail = [d for d in self.devices
                 if d not in self.offline and d not in self.leased]
        if ns.used_devices + n > ns.device_quota:
            raise RuntimeError(
                f"namespace {ns.name}: quota exceeded "
                f"({ns.used_devices}+{n} > {ns.device_quota})")
        if n > len(avail):
            raise RuntimeError(f"cluster: {n} devices requested, "
                               f"{len(avail)} free")
        take = avail[:n]
        self.leased.update(take)
        ns.used_devices += n
        return take

    def _release_pod_locked(self, pod: Pod) -> None:
        """Return a pod's lease (devices + namespace quota).  Idempotent.

        Bills the lease on the way out: ``lease_device_s/<namespace>``
        accumulates device-seconds held (allocation -> release), the
        per-tenant meter the scenario chargeback reads
        (``repro_torch.scenarios``)."""
        if not pod.holds_devices:
            return
        pod.holds_devices = False
        ns = self.namespaces[pod.ctx.namespace]
        for d in pod.ctx.devices:
            self.leased.discard(d)
        ns.used_devices = max(0, ns.used_devices - len(pod.ctx.devices))
        held = max(0.0, time.monotonic() - pod.lease_t0)
        self.metrics.inc(f"lease_device_s/{ns.name}",
                         held * len(pod.ctx.devices))

    # ----------------------------------------------------------------- jobs
    def submit(self, namespace: str, spec: JobSpec) -> Job:
        ns = self.namespaces[namespace]
        job = Job(spec, namespace)
        with self._lock:
            pods: List[Pod] = []
            try:
                for i in range(spec.replicas):
                    devs = self._allocate_locked(ns, spec.devices_per_pod) \
                        if spec.devices_per_pod else []
                    ctx = PodCtx(pod_id=f"{spec.name}-{i}",
                                 namespace=namespace, devices=devs,
                                 metrics=self.metrics, site=self.site)
                    pod = Pod(ctx.pod_id, spec.fn, ctx)
                    pod.holds_devices = bool(devs)
                    pod.lease_t0 = time.monotonic()
                    pods.append(pod)
            except Exception:
                for p in pods:           # all-or-nothing: undo partial leases
                    self._release_pod_locked(p)
                raise
            job.pods.extend(pods)
            self.jobs.append(job)
        for pod in job.pods:
            self._start_pod(pod)
        return job

    def _start_pod(self, pod: Pod) -> None:
        with self._lock:
            pod.gen += 1
            gen = pod.gen

        def run():
            with self._lock:
                # superseded (respawned) or drained while still PENDING
                if pod.gen != gen or pod.state != PodState.PENDING:
                    return
                pod.state = PodState.RUNNING
            self.metrics.inc(f"pods_running/{pod.ctx.namespace}")
            self._notify_pod("running", pod)
            try:
                result, err = pod.fn(pod.ctx), None
            except Exception as e:       # reconciler may respawn
                result = None
                err = f"{e}\n{traceback.format_exc()}"
            with self._lock:
                if pod.gen != gen:       # a respawned attempt owns the pod now
                    return
                # only a RUNNING pod changes state here; a drained one was
                # already flipped (and notified) by fail_node/preempt
                changed = pod.state == PodState.RUNNING
                if err is None:
                    pod.result = result
                    # a drained pod may still finish cooperatively — keep the
                    # result (e.g. its "preempted at step k" marker) but do
                    # not resurrect the FAILED state fail_node assigned.
                    if pod.state == PodState.RUNNING:
                        # a preempt-drained pod that exits cleanly made its
                        # checkpoint: terminal PREEMPTED, never respawned
                        pod.state = PodState.PREEMPTED \
                            if pod.ctx.preempt.is_set() else PodState.SUCCEEDED
                else:
                    if pod.state == PodState.RUNNING:
                        pod.error = err
                        if pod.ctx.preempt.is_set():
                            # crashed while winding down from a preempt:
                            # still an eviction, not a respawnable failure
                            pod.state = PodState.PREEMPTED
                        else:
                            pod.state = PodState.FAILED
                            self.metrics.inc(
                                f"pod_failures/{pod.ctx.namespace}")
                self._release_pod_locked(pod)   # terminal -> return the lease
                final = pod.state
            if changed:
                self._notify_pod(final.name.lower(), pod)

        pod.thread = threading.Thread(target=run, name=pod.pod_id)
        pod.thread.start()

    # ------------------------------------------------------------ controller
    def reconcile(self) -> int:
        """One controller pass: respawn failed pods under the backoff limit.

        A respawn re-allocates devices — the failed attempt's lease was
        released at terminal state and its devices may since have gone
        offline.  If the cluster cannot satisfy the allocation right now
        (quota or free devices), the pod stays FAILED and the next pass
        retries.  Returns the number of pods respawned.
        """
        respawned = 0
        for job in self.jobs:
            for pod in job.pods:
                with self._lock:
                    if not (pod.state == PodState.FAILED and
                            pod.restarts < job.spec.backoff_limit):
                        continue
                    self._release_pod_locked(pod)   # no-op unless drained
                    ns = self.namespaces[job.namespace]
                    try:
                        devs = self._allocate_locked(
                            ns, job.spec.devices_per_pod) \
                            if job.spec.devices_per_pod else []
                    except RuntimeError:
                        self.metrics.inc(
                            f"pod_unschedulable/{job.namespace}")
                        continue
                    pod.restarts += 1
                    pod.ctx = PodCtx(pod.pod_id, job.namespace, devs,
                                     self.metrics, attempt=pod.restarts,
                                     site=self.site)
                    pod.holds_devices = bool(devs)
                    pod.lease_t0 = time.monotonic()
                    pod.error = None
                    pod.state = PodState.PENDING
                self._notify_pod("respawned", pod)
                self._start_pod(pod)
                respawned += 1
        return respawned

    def wait(self, job: Job, *, reconcile_every: float = 0.01,
             timeout: float = 600.0) -> Job:
        """Block until the job succeeds or exhausts its backoff limit.

        The deadline is enforced ACROSS the per-pod joins, not just per
        controller pass: with many pods, one outer iteration used to cost
        ``len(pods) * reconcile_every`` seconds, overshooting a short
        timeout by orders of magnitude when pods hang."""
        deadline = time.monotonic() + timeout
        while True:
            for pod in job.pods:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if pod.thread is not None:
                    pod.thread.join(timeout=min(reconcile_every, remaining))
            if job.succeeded:
                return job
            if job.failed:
                errs = [p.error for p in job.pods if p.error]
                raise RuntimeError(
                    f"job {job.spec.name} failed after backoff: {errs[:1]}")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"job {job.spec.name} timed out")
            self.reconcile()

    # ------------------------------------------------------ preemption (§IV)
    def preempt_pod(self, pod: Pod, *, reason: str = "fair-share") -> bool:
        """Checkpoint-then-evict: the cooperative ``preempt`` drain.

        Unlike ``fail_node`` the hardware is healthy, so the pod is ASKED
        to leave: its ``PodCtx.preempt`` event is set, a cooperative fn
        (e.g. an elastic training segment) checkpoints and exits, and the
        pod lands in the terminal PREEMPTED state — which ``reconcile``
        never respawns; whoever preempted it (the fair-share scheduler, or
        the elastic trainer's ``request_stop``) owns the resubmission.  A still-PENDING pod
        is evicted immediately.  Returns False if the pod was already
        terminal."""
        with self._lock:
            if pod.state == PodState.PENDING:
                pod.state = PodState.PREEMPTED
                pod.error = f"Preempted: {reason}"
                pod.ctx.preempt.set()
                self._release_pod_locked(pod)
                notify = "preempted"
            elif pod.state == PodState.RUNNING:
                pod.ctx.preempt.set()
                pod.error = f"Preempted: {reason}"
                notify = "preempt-requested"
            else:
                return False
        self.metrics.inc(f"pod_preempted/{pod.ctx.namespace}")
        self._notify_pod(notify, pod)
        return True

    def retire_pod(self, pod: Pod) -> bool:
        """Take a FAILED pod out of the reconciler's respawn set by
        flipping it to terminal PREEMPTED.  Used when an external
        scheduler requeues the whole job: a later ``reconcile`` must not
        ALSO respawn the stale pod, or the work runs twice."""
        with self._lock:
            if pod.state != PodState.FAILED:
                return False
            pod.state = PodState.PREEMPTED
            return True

    def finish_preempt(self, pod: Pod) -> bool:
        """Grace expired: hard-evict a preempt-drained pod that has not
        exited.  The pod goes terminal PREEMPTED and its lease returns;
        the zombie thread is fenced by ``Pod.gen``/state checks and its
        late result, if any, is still recorded."""
        with self._lock:
            if not pod.ctx.preempt.is_set() or \
                    pod.state not in (PodState.PENDING, PodState.RUNNING):
                return False
            pod.state = PodState.PREEMPTED
            pod.ctx.stop.set()
            self._release_pod_locked(pod)
        self.metrics.inc(f"pod_preempt_hard/{pod.ctx.namespace}")
        self._notify_pod("preempted", pod)
        return True

    # ------------------------------------------------------- node churn (§V)
    def add_watcher(self, cb: Callable[[str, Any], None]) -> None:
        """Register cb(event, device) for node churn ("fail" | "join")."""
        self._watchers.append(cb)

    def add_pod_watcher(self, cb: Callable[[str, Pod], None]) -> None:
        """Register cb(event, pod) for pod lifecycle transitions: one of
        "running" | "succeeded" | "failed" | "preempted" |
        "preempt-requested" | "respawned".  Feeds the near-real-time
        monitor (repro_torch.vcluster.monitor); observer errors are
        swallowed so a broken subscriber cannot take down the
        controller."""
        self._pod_watchers.append(cb)

    def _notify_pod(self, event: str, pod: Pod) -> None:
        for cb in list(self._pod_watchers):
            try:
                cb(event, pod)
            except Exception:       # observers must never break the loop
                pass

    def fail_node(self, device) -> None:
        """A node drops out: mark it offline AND drain the pods on it.

        Draining marks each affected pod FAILED (so ``reconcile`` reschedules
        it onto surviving devices), releases its lease, and sets its
        ``PodCtx.stop`` event so a cooperative fn can checkpoint and exit.
        """
        drained_pods: List[Pod] = []
        with self._lock:
            self.offline.add(device)
            for job in self.jobs:
                for pod in job.pods:
                    if pod.state in (PodState.PENDING, PodState.RUNNING) \
                            and device in pod.ctx.devices:
                        pod.state = PodState.FAILED
                        pod.error = (f"NodeFailure: device {device!r} "
                                     f"went offline")
                        pod.ctx.stop.set()
                        self._release_pod_locked(pod)
                        drained_pods.append(pod)
        if drained_pods:
            self.metrics.inc("node_drained_pods", len(drained_pods))
        for pod in drained_pods:
            self._notify_pod("failed", pod)
        for cb in list(self._watchers):
            cb("fail", device)

    def fail_all_nodes(self) -> None:
        """Whole-appliance outage: every node goes offline, every pod
        drains — INCLUDING device-less (CPU-only) pods, which the
        per-device drain in fail_node never touches."""
        for d in list(self.devices):
            self.fail_node(d)
        drained_pods: List[Pod] = []
        with self._lock:
            for job in self.jobs:
                for pod in job.pods:
                    if pod.state in (PodState.PENDING, PodState.RUNNING):
                        pod.state = PodState.FAILED
                        pod.error = "NodeFailure: whole site went offline"
                        pod.ctx.stop.set()
                        self._release_pod_locked(pod)
                        drained_pods.append(pod)
        if drained_pods:
            self.metrics.inc("node_drained_pods", len(drained_pods))
        for pod in drained_pods:
            self._notify_pod("failed", pod)

    def queue_depth(self) -> int:
        """Pods admitted but not yet terminal — the congestion signal a
        placement planner folds into its site score."""
        with self._lock:
            return sum(1 for job in self.jobs for p in job.pods
                       if p.state in (PodState.PENDING, PodState.RUNNING))

    def join_node(self, device) -> None:
        with self._lock:
            self.offline.discard(device)
            if device not in self.devices:
                self.devices.append(device)
        for cb in list(self._watchers):
            cb("join", device)

    @property
    def online_devices(self) -> List[Any]:
        return [d for d in self.devices if d not in self.offline]

    @property
    def compute_device(self) -> torch.device:
        """Where this cluster's work computes: its ``compute`` device, else
        its first online device that names a CUDA or CPU device (an int
        or a ``"slot0"`` is a logical slot, never a device).  Raises when
        there is none: work never slides onto the CPU by itself."""
        if self.compute is not None:
            return self.compute
        for d in self.online_devices:
            if isinstance(d, torch.device) or (
                    isinstance(d, str) and d.split(":")[0] in ("cuda", "cpu")):
                return resolve_device(d)
        raise RuntimeError(
            f"cluster {self.site!r} has no online CUDA or CPU device to "
            f"compute on (devices {self.devices}, offline "
            f"{sorted(map(str, self.offline))})")

"""Backend runners — how each workload kind lands on the cluster backend.

A copy of the JAX package's ``api/runners.py`` with its cluster backend:
one runner method per workload kind, all routing into the EXISTING
machinery — ``repro_torch.elastic`` for TrainJob, ``repro_torch.serving``
(one engine, or replicas behind the router) for ServeJob, the
orchestrator for BatchJob, ``core.workflow`` / ``flow`` for WorkflowRun,
and ``repro_torch.rl`` (actor fleet + elastic learner) for RLJob.
Runners execute inside the Handle's reconcile thread: they move the
handle PLACING -> RUNNING, thread its cooperative ``should_stop`` into
the subsystem, and return the workload's result dict.

The fabric backend (``repro_torch.fabric``) places each workload at a
site of the federation: placed workflows, cross-site failover for
training, metered weight traffic for RL.  Training, serving and RL run
on the cluster's ``compute_device`` (the session cluster's first online
CUDA or CPU device; at a fabric site, the fabric's device or the site
cluster's own); the drivers below take it as ``device`` (``"cuda"`` by
default, which raises without a card).  The drivers' ``handle`` may be
``None`` for callers outside a Session (the RL CLI's direct path): no
status probes, no transitions, no cancel hook.  The tenant backend waits
for ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.resources import (BatchJob, ManifestError, RLJob,
                                       ServeJob, TrainJob, WorkflowRun)
from repro_torch.api.session import Handle, WorkloadState
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import JobSpec, PodState
from repro_torch.core.workflow import Workflow
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.serving.report import GAUGES, make_requests, serving_report


# ----------------------------------------------------------- shared builders
def dataclass_kwargs(obj) -> Dict[str, Any]:
    """A dataclass instance's init kwargs — the declarative ``config``
    dict for a TrainJob built from an existing ModelConfig."""
    return {f.name: getattr(obj, f.name)
            for f in dataclasses.fields(obj) if f.init}


def _resolve_pieces(job, steps: int):
    """Shared (ModelConfig, ParallelConfig, OptimizerConfig) resolution
    for any training-flavoured job (TrainJob / RLJob)."""
    if job.config is not None:
        cfg = ModelConfig(**job.config)
        base = OptimizerConfig()
        try:
            par = registry.get_parallel(job.arch)
        except KeyError:
            # a custom model name rode in as the arch: the config IS the
            # model, so fall back to default parallelism
            par = registry.get_parallel("phi4-mini-3.8b")
    else:
        cfg = registry.get_smoke(job.arch) if job.smoke \
            else registry.get_config(job.arch)
        base = registry.get_optimizer(job.arch)
        par = registry.get_parallel(job.arch)
    okw: Dict[str, Any] = dict(
        lr=1e-3, warmup_steps=max(steps // 20, 1),
        decay_steps=steps, moment_dtype=base.moment_dtype,
        second_moment=base.second_moment)
    if job.optimizer:
        okw.update(job.optimizer)
    return cfg, par, OptimizerConfig(**okw)


def train_pieces(job: TrainJob):
    """(ModelConfig, ParallelConfig, OptimizerConfig) for a TrainJob —
    ONE resolution shared by the Session path and the train CLI."""
    return _resolve_pieces(job, job.steps)


def rl_pieces(job: RLJob):
    """(ModelConfig, ParallelConfig, OptimizerConfig) for an RLJob: the
    schedule spans the LEARNER's steps; the actors share the ModelConfig
    so version-0 weights and every published version match their
    engines' schema."""
    return _resolve_pieces(job, job.learner_steps)


def elastic_spec(job: TrainJob, *, namespace: Optional[str] = None,
                 device="cuda"):
    """The ElasticTrainSpec a TrainJob declares, training on ``device``."""
    from repro_torch.elastic.trainer import ElasticTrainSpec
    cfg, par, ocfg = train_pieces(job)
    kw: Dict[str, Any] = {}
    if namespace or job.namespace:
        kw["namespace"] = namespace or job.namespace
    return ElasticTrainSpec(
        cfg, par, ocfg, steps=job.steps, seq_len=job.seq_len,
        global_batch=job.global_batch, base_shape=tuple(job.base_shape),
        max_data=job.max_data, name=job.name, ckpt_every=job.ckpt_every,
        keep=job.keep, log_every=job.log_every,
        device_steps=job.device_steps, seed=job.seed,
        data_seed=job.data_seed, fail_at=job.fail_at,
        rejoin_timeout_s=job.rejoin_timeout_s, verbose=job.verbose,
        device=device, **kw)


def trainer_probe(handle: Handle):
    """A ``step`` status probe bound to THIS workload's live trainer (not
    a shared metrics series another run may have written).  Returns the
    ``on_trainer`` hook that binds each (re)created trainer."""
    holder: Dict[str, Any] = {}
    # before the first trainer exists the probe raises and status() just
    # omits the key — never another workload's step
    handle.probe("step", lambda: holder["trainer"].progress)
    return lambda trainer: holder.__setitem__("trainer", trainer)


def train_result(out: Dict[str, Any]) -> Dict[str, Any]:
    return {"losses": out["losses"], "loss_by_step": out["loss_by_step"],
            "params": out["params"], "opt": out.get("opt"),
            "report": out["report"]}


# ------------------------------------------------------------------ serving
def resolve_serve_cfg(job: ServeJob) -> ModelConfig:
    return registry.get_smoke(job.arch) if job.smoke \
        else registry.get_config(job.arch)


def build_engine(job: ServeJob, *, registry_out: Optional[Registry] = None,
                 device="cuda"):
    """The continuous-batching engine a ServeJob declares, on ``device``."""
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(resolve_serve_cfg(job), device=device,
                         num_slots=job.slots, prompt_len=job.prompt_len,
                         max_new_tokens=job.max_new_tokens, seed=job.seed,
                         registry=registry_out,
                         paged=job.paged, block_size=job.block_size,
                         pool_blocks=job.pool_blocks,
                         prefix_cache=job.prefix_cache)


def serve_requests(job: ServeJob) -> List[dict]:
    if job.requests is not None:
        return [dict(r) for r in job.requests]
    return make_requests(job.n_requests, job.prompt_len, job.max_new_tokens,
                         vocab_size=resolve_serve_cfg(job).vocab_size,
                         seed=job.seed, gen_lens=job.gen_lens)


def run_serve_replicated(handle: Optional[Handle], job: ServeJob,
                         metrics: Registry, *, capacity=None,
                         device="cuda"):
    """N engines behind the session-affine router, scaled by the
    autoscaler between ``job.min_replicas`` and ``job.max_replicas``.
    Scale decisions surface on the Handle as ``replicas:
    desired→observed`` detail; ``capacity`` optionally gates scale-up."""
    from repro_torch.serving.router import serve_replicated

    def factory(name, reg, dev):
        engine = build_engine(job, registry_out=reg, device=dev)
        if job.warmup:
            engine.warmup()
        return engine

    on_scale = should_stop = None
    if handle is not None:
        def on_scale(desired, observed, reason):
            handle._transition(WorkloadState.RUNNING,
                               replicas=f"{desired}→{observed}",
                               reason=reason)
        should_stop = handle.should_stop
        handle.probe("completed",
                     lambda: int(metrics.series(GAUGES.COMPLETED).total))
        handle.probe("replicas",
                     lambda: int(metrics.series(GAUGES.REPLICAS).last))
        handle._transition(WorkloadState.RUNNING, slots=job.slots,
                           replicas=f"{job.min_replicas}→0")
    results, metrics, events = serve_replicated(
        factory, serve_requests(job), device=device,
        min_replicas=job.min_replicas, max_replicas=job.max_replicas,
        target_backlog=job.target_backlog, ttft_slo_s=job.ttft_slo_s,
        lease_timeout=job.lease_timeout, registry=metrics,
        should_stop=should_stop, on_scale=on_scale, capacity=capacity)
    return {"results": results, "metrics": metrics,
            "scale_events": events,
            "report": serving_report(metrics, step=job.name)}


# ----------------------------------------------------------------------- RL
def build_rl_engine(job: RLJob, cfg: ModelConfig, *, registry_out=None,
                    device="cuda"):
    """One actor's engine, built from the SAME resolved ModelConfig as the
    learner so published weight trees always match its schema."""
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, device=device, num_slots=job.slots,
                         prompt_len=job.prompt_len,
                         max_new_tokens=job.max_new_tokens, seed=job.seed,
                         registry=registry_out, paged=job.paged,
                         block_size=job.block_size,
                         pool_blocks=job.pool_blocks,
                         prefix_cache=job.prefix_cache)


def run_rl_fleet(handle: Optional[Handle], job: RLJob, *, learner_store,
                 actor_store=None, metrics: Registry, capacity=None,
                 device="cuda"):
    """Ticket feeder + actor fleet + learner, on ``device``.

    The feeder emits rollout tickets in *waves*: a burst is enqueued
    only once the shared ticket queue is fully idle (no pending AND no
    leased), which is exactly when every actor has exited its engine
    wave and polled the policy store — so actors observe version bumps
    between waves and the replay backlog (capped at ~2 learner chunks)
    cannot age past ``max_policy_lag`` in steady state.  ``actor_store``
    (default: the learner's) is where the actors fetch weights from."""
    from repro_torch.rl import (ActorFleet, PolicyStore, RLLearner,
                                RLLearnerSpec, RolloutActor, RolloutQueue,
                                ticket_queue)

    dev = resolve_device(device)
    cfg, par, ocfg = rl_pieces(job)
    spec = RLLearnerSpec(
        cfg, par, ocfg, steps=job.learner_steps, seq_len=job.seq_len,
        batch=job.rollouts_per_step, device_steps=job.device_steps,
        ckpt_every=job.ckpt_every, broadcast_every=job.broadcast_every,
        max_policy_lag=job.max_policy_lag, seed=job.seed, keep=job.keep,
        fail_at=job.fail_at, device=dev)
    tickets = ticket_queue(lease_timeout=job.lease_timeout)
    rollouts = RolloutQueue(lease_timeout=job.lease_timeout,
                            registry=metrics)
    publish = PolicyStore(learner_store, registry=metrics)
    subscribe = publish if actor_store is None \
        else PolicyStore(actor_store, registry=metrics)
    prompts: Dict[Any, List[int]] = {}

    def make_actor(name):
        return RolloutActor(name, build_rl_engine(job, cfg, device=dev),
                            tickets, rollouts, subscribe, prompts=prompts,
                            registry=metrics)

    fleet = ActorFleet(make_actor, width=job.actors, capacity=capacity,
                       registry=metrics, name=f"{job.name}-actor")
    learner = RLLearner(spec, rollouts, publish, store=learner_store,
                        registry=metrics, name=job.name)
    stop_feed = threading.Event()
    should_stop = None
    if handle is not None:
        handle.probe("learner_step", lambda: learner.report.steps_done)
        handle.probe("policy_version", lambda: learner.version)
        handle.probe("actors", lambda: fleet.width)
        handle.probe("rollouts_trained", lambda: rollouts.trained)
        handle.add_cancel_hook(stop_feed.set)
        should_stop = handle.should_stop
    rng = np.random.default_rng(job.seed + 101)
    burst = max(job.rollouts_per_step, job.actors * job.slots)
    backlog_cap = 2 * job.rollouts_per_step * max(job.device_steps, 1)
    n_fed = [0]

    def feed():
        while not stop_feed.is_set():
            if (tickets.pending > 0 or tickets.leased > 0
                    or rollouts.pending >= backlog_cap):
                time.sleep(2e-3)
                continue
            for _ in range(burst):
                rid = f"t{n_fed[0]:05d}"
                n_fed[0] += 1
                prompt = [int(x) for x in rng.integers(
                    1, cfg.vocab_size, size=job.prompt_len)]
                prompts[rid] = prompt
                tickets.put({"id": rid, "prompt": prompt,
                             "max_new_tokens": job.max_new_tokens})

    feeder = threading.Thread(target=feed, name=f"{job.name}-feeder",
                              daemon=True)
    if handle is not None:
        handle._transition(WorkloadState.RUNNING, actors=job.actors,
                           steps=job.learner_steps)
    granted = fleet.start()
    feeder.start()
    min_syncs = 0
    try:
        out = learner.run_supervised(should_stop)
        # the final version is published after the last step: give the
        # (now idle) actors one beat to observe it before teardown
        deadline = time.monotonic() + 10.0
        while fleet.min_syncs() < 1 and time.monotonic() < deadline \
                and fleet.width > 0:
            time.sleep(5e-3)
        min_syncs = fleet.min_syncs()
    finally:
        stop_feed.set()
        fleet.stop_all()
        feeder.join(timeout=10.0)
    rep = learner.report
    return {
        "done": bool(out.get("done")),
        "preempted": bool(out.get("preempted")),
        "report": dataclasses.asdict(rep),
        "losses": list(rep.losses),
        "steps_done": rep.steps_done,
        "steps_lost": rep.steps_lost,
        "recoveries": rep.recoveries,
        "publishes": rep.publishes,
        "final_version": rep.final_version,
        "trained": rollouts.trained,
        "stale_dropped": rollouts.stale_dropped,
        "max_lag_trained": rollouts.max_lag_trained(),
        "rollouts_pushed": rollouts.pushed,
        "tickets_fed": n_fed[0],
        "actors_granted": granted,
        "min_actor_syncs": min_syncs,
        "actor_syncs": {n: a.syncs for n, a in fleet.actors.items()},
        "actor_metrics": {n: a.engine.metrics
                          for n, a in fleet.actors.items()},
        # seconds and bytes of each publish, fetch and learner checkpoint
        "policy_saves": list(publish.ckpt.saves),
        "policy_fetches": list(subscribe.ckpt.restores),
        "learner_saves": list(learner.ckpt.saves),
        "metrics": metrics,
    }


# ---------------------------------------------------- batch jobs, workflows
def _watch_job(handle: Handle, cluster, job, *, poll_s: float = 0.01,
               grace_s: float = 10.0):
    """The batch-job reconcile loop: respawn failures via the cluster
    controller, drain cooperatively on cancel (preempt -> grace ->
    hard-evict), surface platform preemption as a terminal state."""
    preempted_at: Optional[float] = None
    while True:
        if handle.cancel_requested:
            now = time.monotonic()
            if preempted_at is None:
                preempted_at = now
                for pod in job.pods:
                    if pod.state in (PodState.PENDING, PodState.RUNNING):
                        cluster.preempt_pod(
                            pod, reason=f"api cancel: {handle.spec.name}")
            elif now - preempted_at > grace_s:
                for pod in job.pods:
                    cluster.finish_preempt(pod)
        if job.succeeded:
            return job.results()
        if job.terminal and job.preempted:
            if not handle.cancel_requested:
                handle._set_final(WorkloadState.PREEMPTED)
            return job.results()
        if job.failed:
            errs = [p.error for p in job.pods if p.error]
            raise RuntimeError(
                f"job {job.spec.name} failed after backoff: {errs[:1]}")
        if not handle.cancel_requested:
            cluster.reconcile()
        time.sleep(poll_s)


def _run_workflow(handle: Handle, run: WorkflowRun, wf: Workflow):
    handle.probe("steps_done", lambda: len(wf.reports))
    if run.graph is not None:
        # workflow program: compile the declarative graph and run ready
        # branches concurrently over the backend (repro_torch.flow)
        from repro_torch.flow import GraphRunner
        runner = GraphRunner(wf, run.graph, max_workers=run.max_workers)
        handle._transition(WorkloadState.RUNNING, mode="graph",
                           steps=runner.program.size)
        results = runner.run(resume=run.resume, only=run.only,
                             should_stop=handle.should_stop)
    else:
        define = run.resolve_define()
        define(wf)
        handle._transition(WorkloadState.RUNNING, steps=len(wf.steps))
        results = wf.run(resume=run.resume, only=run.only,
                         should_stop=handle.should_stop)
    return {"results": results, "reports": wf.reports,
            "table": wf.table_one()}


# ------------------------------------------------------------------ backend
class ClusterBackend:
    """One bare orchestrator Cluster (+ optional ObjectStore)."""

    kind = "cluster"

    def __init__(self, session, cluster, store: Optional[ObjectStore]):
        self.session = session
        self.cluster = cluster
        self.store = store
        self.metrics = session.metrics

    @property
    def device(self) -> torch.device:
        """Where training, serving and RL run: the cluster's compute device
        (its first online CUDA or CPU device; a cluster of bare logical
        slots runs batch jobs only)."""
        return self.cluster.compute_device

    # ------------------------------------------------------------ TrainJob
    def run_train(self, handle: Handle, job: TrainJob):
        from repro_torch.elastic.trainer import ElasticTrainer
        handle._transition(WorkloadState.PLACING)
        tspec = elastic_spec(job, device=self.device)
        store = ObjectStore(job.ckpt_dir) if job.ckpt_dir else None
        stop = threading.Event()
        trainer = ElasticTrainer(self.cluster, tspec, store=store,
                                 metrics=self.metrics, stop=stop)
        handle.add_cancel_hook(stop.set)
        handle.probe("step", lambda: trainer.progress)
        handle._transition(WorkloadState.RUNNING,
                           devices=len(self.cluster.online_devices))
        return train_result(trainer.run())

    # ------------------------------------------------------------ ServeJob
    def run_serve(self, handle: Handle, job: ServeJob):
        from repro_torch.core.queue import WorkQueue
        handle._transition(WorkloadState.PLACING)
        metrics = Registry()
        if job.max_replicas > 1:
            return run_serve_replicated(handle, job, metrics,
                                        device=self.device)
        engine = build_engine(job, registry_out=metrics, device=self.device)
        queue = WorkQueue(serve_requests(job),
                          lease_timeout=job.lease_timeout)
        if job.warmup:
            engine.warmup()
        handle.probe("completed",
                     lambda: int(metrics.series(GAUGES.COMPLETED).total))
        handle._transition(WorkloadState.RUNNING, slots=job.slots)
        results, metrics = engine.run(queue,
                                      default_max_new=job.max_new_tokens,
                                      should_stop=handle.should_stop)
        return {"results": results, "metrics": metrics,
                "report": serving_report(metrics, step=job.name)}

    # ------------------------------------------------------------ BatchJob
    def run_batch(self, handle: Handle, job: BatchJob):
        fn = job.resolve_fn()
        ns = job.namespace or self.session.namespace or "default"
        if ns not in self.cluster.namespaces:
            self.cluster.create_namespace(ns)
        handle._transition(WorkloadState.PLACING, namespace=ns)
        kjob = self.cluster.submit(ns, JobSpec(
            job.name, fn, replicas=job.replicas,
            devices_per_pod=job.devices_per_pod,
            backoff_limit=job.backoff_limit, priority=job.priority))
        handle._transition(WorkloadState.RUNNING, replicas=job.replicas)
        return {"results": _watch_job(handle, self.cluster, kjob)}

    # --------------------------------------------------------------- RLJob
    def run_rl(self, handle: Handle, job: RLJob):
        """The learner checkpoints and publishes to ``job.ckpt_dir``, else
        to the session's store, else to a temporary directory removed
        when the workload ends."""
        handle._transition(WorkloadState.PLACING)
        device = self.device
        if job.ckpt_dir or self.store is not None:
            store = ObjectStore(job.ckpt_dir) if job.ckpt_dir else self.store
            return run_rl_fleet(handle, job, learner_store=store,
                                metrics=Registry(), device=device)
        with tempfile.TemporaryDirectory(prefix="rl-ckpt-") as root:
            return run_rl_fleet(handle, job, learner_store=ObjectStore(root),
                                metrics=Registry(), device=device)

    # --------------------------------------------------------- WorkflowRun
    def run_workflow(self, handle: Handle, run: WorkflowRun):
        if self.store is None:
            raise ManifestError(
                "WorkflowRun on a bare cluster needs Session(cluster=..., "
                "store=ObjectStore(...)) for step markers")
        handle._transition(WorkloadState.PLACING)
        wf = Workflow(run.name, cluster=self.cluster, store=self.store,
                      metrics=self.metrics,
                      namespace=run.namespace or self.session.namespace
                      or "default", bus=self.session.bus)
        return _run_workflow(handle, run, wf)


class FabricBackend:
    """The multi-site federation (``repro_torch.fabric``) — placed
    workloads, cross-site failover."""

    kind = "fabric"

    def __init__(self, session, fabric, planner, store):
        self.session = session
        self.fabric = fabric
        self.planner = planner
        self.store = store
        self.metrics = session.metrics

    def _need_planner(self, what: str):
        if self.planner is None:
            raise ManifestError(
                f"{what} on a fabric session needs "
                f"Session(planner=PlacementPlanner(FederatedStore(...))) "
                f"for placement + replica tracking")
        return self.planner

    def _pick_site(self, job, need: int):
        if job.site is not None:
            site = self.fabric.sites[job.site]
            if not site.up:
                raise RuntimeError(f"site {job.site!r} is down")
            return site
        cands = [s for s in self.fabric.up_sites()
                 if len(s.cluster.online_devices) >= max(need, 1)]
        if not cands:
            raise RuntimeError(
                f"no live site can host {job.name!r} ({need} devices)")
        return min(cands, key=lambda s: (s.queue_depth(), -s.capacity,
                                         s.name))

    # ------------------------------------------------------------ TrainJob
    def run_train(self, handle: Handle, job: TrainJob):
        from repro_torch.fabric.failover import run_elastic_federated
        planner = self._need_planner("TrainJob")
        handle._transition(WorkloadState.PLACING)
        stop = threading.Event()
        handle.add_cancel_hook(stop.set)
        on_trainer = trainer_probe(handle)
        handle._transition(WorkloadState.RUNNING)
        # each site's trainer computes on that site's device
        result = run_elastic_federated(
            planner, elastic_spec(job, device=self.fabric.device),
            metrics=self.metrics, stop=stop, on_trainer=on_trainer)
        out = train_result(result.out) if result.out else {}
        out.update({"sites": result.sites,
                    "migrations": result.migrations,
                    "report": result.report})
        return out

    # ------------------------------------------------------------ ServeJob
    def run_serve(self, handle: Handle, job: ServeJob):
        handle._transition(WorkloadState.PLACING)
        from repro_torch.core.queue import WorkQueue
        site = self._pick_site(job, 1)
        ns = self.session.namespace or "serve"
        if ns not in site.cluster.namespaces:
            site.cluster.create_namespace(ns)
        queue = WorkQueue(serve_requests(job),
                          lease_timeout=job.lease_timeout)

        def serve_pod(ctx):
            # built on the pod's clock, on its site's device
            engine = build_engine(job, device=site.cluster.compute_device)
            results, metrics = engine.run(
                queue, default_max_new=job.max_new_tokens,
                should_stop=lambda: ctx.should_stop() or
                handle.should_stop())
            return {"results": results,
                    "report": serving_report(metrics, step=job.name)}

        kjob = site.cluster.submit(ns, JobSpec(
            job.name, serve_pod, replicas=1, devices_per_pod=1,
            backoff_limit=1))
        handle._transition(WorkloadState.RUNNING, site=site.name)
        pods = _watch_job(handle, site.cluster, kjob)
        out = pods[0] if pods and pods[0] is not None \
            else {"results": {}, "report": None}
        out["site"] = site.name
        return out

    # ------------------------------------------------------------ BatchJob
    def run_batch(self, handle: Handle, job: BatchJob):
        fn = job.resolve_fn()
        ns = job.namespace or self.session.namespace or "default"
        handle._transition(WorkloadState.PLACING)
        site = self._pick_site(job, job.devices_per_pod * job.replicas)
        if ns not in site.cluster.namespaces:
            site.cluster.create_namespace(ns)
        kjob = site.cluster.submit(ns, JobSpec(
            job.name, fn, replicas=job.replicas,
            devices_per_pod=job.devices_per_pod,
            backoff_limit=job.backoff_limit, priority=job.priority))
        handle._transition(WorkloadState.RUNNING, site=site.name)
        return {"results": _watch_job(handle, site.cluster, kjob),
                "site": site.name}

    # --------------------------------------------------------------- RLJob
    def run_rl(self, handle: Handle, job: RLJob):
        """Actors and learner at (possibly) different sites of the
        federation: the learner publishes weight versions into its
        site's store view, actors fetch through THEIR site's view, so
        every pull-on-bump is a metered cross-link transfer.  Both
        compute on the actors' site's device."""
        planner = self._need_planner("RLJob")
        handle._transition(WorkloadState.PLACING)
        actor_site = self._pick_site(job, job.actors)
        if job.learner_site is not None:
            learner_site = self.fabric.sites[job.learner_site]
            if not learner_site.up:
                raise RuntimeError(f"site {job.learner_site!r} is down")
        else:
            learner_site = actor_site
        handle._transition(WorkloadState.PLACING, site=actor_site.name,
                           learner_site=learner_site.name)
        fed = planner.fed
        learner_store = fed.view(learner_site.name)
        actor_store = None if learner_site.name == actor_site.name \
            else fed.view(actor_site.name)
        out = run_rl_fleet(handle, job, learner_store=learner_store,
                           actor_store=actor_store, metrics=Registry(),
                           device=actor_site.cluster.compute_device)
        out["site"] = actor_site.name
        out["learner_site"] = learner_site.name
        return out

    # --------------------------------------------------------- WorkflowRun
    def run_workflow(self, handle: Handle, run: WorkflowRun):
        planner = self._need_planner("WorkflowRun")
        handle._transition(WorkloadState.PLACING)
        wf = Workflow(run.name, planner=planner, metrics=self.metrics,
                      namespace=run.namespace or self.session.namespace
                      or "default", bus=self.session.bus)
        return _run_workflow(handle, run, wf)

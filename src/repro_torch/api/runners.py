"""Drivers for the serving fleet and the RL workload.

From the JAX package's ``api/runners.py``: ``build_engine`` and
``run_serve_replicated`` (a ServeJob's replicas behind the router), and
``rl_pieces``, ``build_rl_engine`` and ``run_rl_fleet`` (an RLJob's
ticket feeder, actor fleet and learner).  The backends (cluster, fabric,
tenant) wait for the port's copy of the session API; the drivers take
an optional ``handle``: with ``None`` there are no status probes, no
state transitions and no cancel hook, otherwise it is duck-typed as the
JAX ``Handle`` (``probe``, ``_transition``, ``should_stop``,
``add_cancel_hook``).  Every driver takes ``device`` (``"cuda"`` by
default, which raises without a card).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List

import numpy as np

from repro_torch.api.resources import RLJob, ServeJob
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.metrics import Registry
from repro_torch.device import resolve_device
from repro_torch.serving.report import GAUGES, make_requests, serving_report

RUNNING = "Running"      # the JAX WorkloadState.RUNNING value


def dataclass_kwargs(obj) -> Dict[str, Any]:
    """A dataclass instance's init kwargs — the ``config`` dict of a job
    built from an existing ModelConfig."""
    return {f.name: getattr(obj, f.name)
            for f in dataclasses.fields(obj) if f.init}


def _resolve_pieces(job, steps: int):
    """(ModelConfig, ParallelConfig, OptimizerConfig) for a
    training-flavoured job: the JAX recipe (lr 1e-3, warmup steps/20,
    decay over ``steps``; the port's archs keep the default moments)."""
    if job.config is not None:
        cfg = ModelConfig(**job.config)
        try:
            par = registry.get_parallel(job.arch)
        except KeyError:
            par = registry.get_parallel("phi4-mini-3.8b")
    else:
        cfg = registry.get_smoke(job.arch) if job.smoke \
            else registry.get_config(job.arch)
        par = registry.get_parallel(job.arch)
    okw: Dict[str, Any] = dict(lr=1e-3, warmup_steps=max(steps // 20, 1),
                               decay_steps=steps)
    if job.optimizer:
        okw.update(job.optimizer)
    return cfg, par, OptimizerConfig(**okw)


def rl_pieces(job: RLJob):
    """(ModelConfig, ParallelConfig, OptimizerConfig) for an RLJob: the
    schedule spans the LEARNER's steps; the actors share the ModelConfig
    so version-0 weights and every published version match their
    engines' schema."""
    return _resolve_pieces(job, job.learner_steps)


# ------------------------------------------------------------------ serving
def resolve_serve_cfg(job: ServeJob) -> ModelConfig:
    return registry.get_smoke(job.arch) if job.smoke \
        else registry.get_config(job.arch)


def build_engine(job: ServeJob, *, registry_out=None, device="cuda"):
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


def run_serve_replicated(handle, job: ServeJob, metrics: Registry, *,
                         capacity=None, device="cuda"):
    """N engines behind the session-affine router, scaled by the
    autoscaler between ``job.min_replicas`` and ``job.max_replicas``;
    ``capacity`` optionally gates scale-up."""
    from repro_torch.serving.router import serve_replicated

    def factory(name, reg, dev):
        engine = build_engine(job, registry_out=reg, device=dev)
        if job.warmup:
            engine.warmup()
        return engine

    on_scale = should_stop = None
    if handle is not None:
        def on_scale(desired, observed, reason):
            handle._transition(RUNNING, replicas=f"{desired}→{observed}",
                               reason=reason)
        should_stop = handle.should_stop
        handle.probe("completed",
                     lambda: int(metrics.series(GAUGES.COMPLETED).total))
        handle.probe("replicas",
                     lambda: int(metrics.series(GAUGES.REPLICAS).last))
        handle._transition(RUNNING, slots=job.slots,
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


def run_rl_fleet(handle, job: RLJob, *, learner_store, actor_store=None,
                 metrics: Registry, capacity=None, device="cuda"):
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
        handle._transition(RUNNING, actors=job.actors,
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

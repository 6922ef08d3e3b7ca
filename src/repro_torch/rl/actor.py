"""Rollout actors — the serving plane of the RL workload.

A copy of the JAX package's ``rl/actor.py`` over the port's
``ServingEngine``: on the card every actor prefill runs the flash kernel.

Each :class:`RolloutActor` owns one continuous-batching
``ServingEngine`` (paged KV when the model family supports it) and
serves rollout *tickets* from the fleet-shared ticket queue in waves:
between waves it polls the :class:`~repro_torch.rl.weights.PolicyStore` and
pulls-on-version-bump (hot-swapping ``engine.params`` — the engine
threads weights through every fused step, so the next prefill decodes
under the new policy), then drains the shared queue with continuous
batching, scores each completion with the reward function, and pushes
version-stamped trajectories into the learner's
:class:`~repro_torch.rl.replay.RolloutQueue`.

Preemption tolerance is inherited, not bolted on: a killed actor's
engine nacks its in-flight ticket leases on the stop path (and a hard
crash is reclaimed at lease expiry), so surviving actors lease the same
tickets from the shared queue and finish them — no trajectory is lost.
:class:`ActorFleet` turns that into elasticity: fleet width moves
through an optional ``capacity`` gate, and ``kill()`` is the chaos hook.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.queue import WorkQueue
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.rl.replay import RolloutQueue, Trajectory
from repro_torch.rl.weights import PolicyStore


def default_reward(prompt, tokens) -> float:
    """Deterministic synthetic reward: distinct-token fraction of the
    generation (a proxy for non-degenerate output; no external judge in
    a single-container run)."""
    return len(set(tokens)) / max(len(tokens), 1)


class RolloutActor:
    """One serving replica generating trajectories in waves."""

    def __init__(self, name: str, engine, tickets: WorkQueue,
                 rollouts: RolloutQueue, policies: PolicyStore, *,
                 prompts: Dict[Any, List[int]],
                 reward_fn: Callable = default_reward,
                 registry=None, poll_s: float = 2e-3):
        self.name = name
        self.engine = engine
        self.tickets = tickets
        self.rollouts = rollouts
        self.policies = policies
        self.prompts = prompts          # ticket rid -> prompt tokens (shared)
        self.reward_fn = reward_fn
        self.metrics = registry
        self.poll_s = poll_s
        self.version = 0                # initial seeded weights = version 0
        self.syncs = 0                  # observed weight-version bumps
        self.completed = 0
        self._stop = threading.Event()
        self._abstract = pr.abstract_params(tfm.lm_schema(engine.cfg),
                                            engine.cfg.param_dtype)

    # ------------------------------------------------------------ weight sync
    def maybe_sync(self) -> bool:
        """Pull-on-version-bump: swap ``engine.params`` iff the store
        advertises a newer committed version than the one held."""
        latest = self.policies.latest_version()
        if latest <= self.version:
            return False
        params, got = self.policies.fetch(self._abstract, self.engine.device)
        if params is None or got <= self.version:
            return False
        self.engine.params = params
        self.version = got
        self.syncs += 1
        if self.metrics is not None:
            self.metrics.gauge(f"rl/actor/{self.name}/version", got)
        return True

    # ------------------------------------------------------------------ waves
    def run(self) -> None:
        """Serve until stopped: sync weights, drain the shared ticket
        queue with continuous batching, push scored trajectories."""
        while not self._stop.is_set():
            self.maybe_sync()
            if self.tickets.pending == 0:
                time.sleep(self.poll_s)
                continue
            version = self.version
            results, _ = self.engine.run(
                self.tickets, worker=self.name,
                should_stop=self._stop.is_set, exit_on_drain=True)
            for rid, toks in results.items():
                prompt = self.prompts.get(rid, [])
                self.rollouts.push(Trajectory(
                    ticket=rid, prompt=tuple(prompt), tokens=tuple(toks),
                    reward=self.reward_fn(prompt, toks),
                    policy_version=version, actor=self.name))
                self.completed += 1

    def stop(self) -> None:
        """Cooperative kill: the engine's stop path nacks in-flight
        ticket leases back to the shared queue for the survivors."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()


class ActorFleet:
    """Elastic-width fleet of rollout actors.

    ``make_actor(name)`` builds one actor; ``capacity`` optionally gates
    desired width to granted width (a fair-share claim)."""

    def __init__(self, make_actor: Callable[[str], RolloutActor], *,
                 width: int, capacity: Optional[Callable[[int], int]] = None,
                 registry=None, name: str = "actor"):
        self.make_actor = make_actor
        self.capacity = capacity
        self.metrics = registry
        self.name = name
        self.desired = width
        self._n_spawned = 0
        self._actors: Dict[str, RolloutActor] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self.resize_events: List[Dict[str, int]] = []

    # -------------------------------------------------------------- lifecycle
    def start(self) -> int:
        return self.resize(self.desired)

    def _spawn(self) -> str:
        name = f"{self.name}-{self._n_spawned}"
        self._n_spawned += 1
        actor = self.make_actor(name)
        t = threading.Thread(target=actor.run, name=name, daemon=True)
        self._actors[name] = actor
        self._threads[name] = t
        t.start()
        return name

    def resize(self, want: int) -> int:
        """Grow/shrink toward ``want``, clamped by the capacity gate.
        Returns the granted width."""
        granted = self.capacity(want) if self.capacity else want
        while self.width < granted:
            self._spawn()
        while self.width > granted:
            # shrink from the newest actor; its engine nacks in-flight
            name = sorted(self.alive())[-1]
            self._actors[name].stop()
            self._join(name)
        self.resize_events.append({"want": want, "granted": granted})
        if self.metrics is not None:
            self.metrics.gauge("rl/actors", self.width)
        return granted

    def kill(self, name: str, *, join: bool = True) -> None:
        """Chaos hook: stop one actor mid-wave (its leases requeue)."""
        self._actors[name].stop()
        if join:
            self._join(name)

    def _join(self, name: str) -> None:
        t = self._threads.pop(name, None)
        if t is not None:
            t.join(timeout=60.0)

    def stop_all(self) -> None:
        for a in self._actors.values():
            a.stop()
        for name in list(self._threads):
            self._join(name)

    # ---------------------------------------------------------------- inspect
    def alive(self) -> List[str]:
        return [n for n, a in self._actors.items() if not a.stopped]

    @property
    def width(self) -> int:
        return len(self.alive())

    @property
    def actors(self) -> Dict[str, RolloutActor]:
        return dict(self._actors)

    def min_syncs(self) -> int:
        """Weight-version bumps observed by the least-synced actor that
        is still alive (the acceptance wants >= 1 across the fleet)."""
        alive = [self._actors[n] for n in self.alive()]
        return min((a.syncs for a in alive), default=0)

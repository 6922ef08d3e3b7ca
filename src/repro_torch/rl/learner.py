"""The RL learner — policy-gradient training off the rollout queue.

A port of the JAX package's ``rl/learner.py``.  One :class:`RLLearner`
drains trajectory batches from the :class:`~repro_torch.rl.replay.RolloutQueue`
(lease + heartbeat, staleness filter applied at the queue), encodes them
into advantage-weighted LM batches, and runs chunks of optimizer steps
through ``runtime.steps.rl_train_chunk`` — the supervised ``train_chunk``
(AdamW in place, metrics stacked (K,) on the device, one host sync a
chunk) with the policy-gradient loss.  On the card its loss runs the xent
kernels and its update the AdamW kernel.  It trains every decoder-only
family on token rollouts (MoE and the recurrent kinds through their
kernels' train paths); whisper has no policy-gradient loss, as in the
reference, and the VLM's rollouts carry no image embeddings, so
``rl_train_chunk`` raises for both.

Elasticity mirrors the elastic trainer's segment contract:

  * periodic checkpoints every ``ckpt_every`` steps (snapped up to chunk
    granularity) carry (params, opt) plus the rollout queue snapshot and
    the current policy version in ``extra``;
  * ``run()`` is ONE resumable segment: restore-or-init, train until
    done / preempted / crashed; a cooperative stop goodbye-saves;
  * ``run_supervised()`` adds the crash loop: an injected hard failure
    (``fail_at``, no goodbye save) loses at most the steps since the
    last periodic checkpoint (``steps_lost <= ckpt_every``);
  * every ``broadcast_every`` steps the learner publishes a new weight
    version through the :class:`~repro_torch.rl.weights.PolicyStore`.

Where the port differs from the JAX learner, on purpose: after a crash
it rewinds the rollout queue to the restored checkpoint's snapshot
(``RolloutQueue.rewind``), so the re-executed steps train on the same
rollouts and repeat the lost steps' losses bit for bit; ``steps_lost``
also counts a restart from step 0 when no checkpoint existed yet.  The
report adds each step's grad norm and reward mean and spread, and each
chunk's seconds and wait for rollouts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig)
from repro_torch.device import resolve_device
from repro_torch.elastic.trainer import chunk_schedule, snap_cadence
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.rl.replay import RolloutQueue, Trajectory
from repro_torch.rl.weights import PolicyStore
from repro_torch.runtime import steps as steps_mod


class InjectedLearnerFailure(RuntimeError):
    """The deterministic hard-crash used by tests: raised AFTER a step
    completes, WITHOUT a goodbye save, so the resume path pays the real
    restore-from-periodic-checkpoint cost."""


@dataclass
class RLLearnerSpec:
    cfg: ModelConfig
    par: ParallelConfig
    ocfg: OptimizerConfig
    steps: int
    seq_len: int                 # prompt_pad + max_new_tokens (S)
    batch: int                   # trajectories per optimizer step (B)
    device_steps: int = 1        # optimizer steps a chunk (K)
    ckpt_every: int = 2
    broadcast_every: int = 2
    max_policy_lag: int = 2
    seed: int = 0
    keep: int = 3
    fail_at: int = -1            # inject ONE hard crash after this step
    drain_poll_s: float = 2e-3
    drain_timeout_s: float = 300.0
    device: Any = "cuda"


@dataclass
class RLRunReport:
    steps: int = 0
    steps_done: int = 0          # completed optimizer steps (monotone)
    steps_lost: int = 0          # re-executed after crash/preempt resumes
    recoveries: int = 0          # crash resumes
    preemptions: int = 0         # cooperative (goodbye-saved) stops
    publishes: int = 0
    final_version: int = 0
    host_syncs: int = 0
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    chunk_s: List[float] = field(default_factory=list)   # dispatch to sync
    drain_s: List[float] = field(default_factory=list)   # waiting for rollouts
    # each step's batch: mean and spread of its rewards (a spread of 0
    # gives zero advantages, so a zero loss and gradient)
    reward_mean: List[float] = field(default_factory=list)
    reward_std: List[float] = field(default_factory=list)
    segments: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def completed(self) -> bool:
        return self.steps_done >= self.steps > 0


def _clone(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _clone(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


class RLLearner:
    """Drain -> encode -> chunk of steps -> publish/checkpoint loop.

    ``init`` is an optional initial ``(params, opt)`` (copied, never
    updated in place); by default params are drawn from ``spec.seed`` as
    the actors' engines draw theirs, so version 0 is the same on both
    planes, and the moments start at zero.
    """

    def __init__(self, spec: RLLearnerSpec, rollouts: RolloutQueue,
                 policies: PolicyStore, *, store, registry=None,
                 name: str = "learner", init=None):
        self.spec = spec
        self.device = resolve_device(spec.device)
        self.rollouts = rollouts
        self.policies = policies
        self.metrics = registry
        self.name = name
        self.ckpt = Checkpointer(store, prefix=f"rl/{name}", keep=spec.keep)
        self.report = RLRunReport(steps=spec.steps)
        self.version = 0
        self._init = init
        self._failed_once = False
        self._crashed = False
        self._queue_at_start: Optional[dict] = None
        self._schema = steps_mod._model_module(spec.cfg).lm_schema(spec.cfg)
        self._opt_schema = adamw.opt_state_schema(self._schema, spec.ocfg)

    def _abstract(self):
        return {"params": pr.abstract_params(self._schema,
                                             self.spec.cfg.param_dtype),
                "opt": pr.abstract_params(self._opt_schema, "float32")}

    def _init_state(self):
        if self._init is not None:
            return _clone(self._init[0], self.device), \
                _clone(self._init[1], self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        params = pr.init_params(self._schema, gen, self.spec.cfg.param_dtype,
                                self.device)
        return params, steps_mod.init_opt_state(self.spec.cfg, self.spec.ocfg,
                                                self.device)

    # ----------------------------------------------------------------- encode
    def encode(self, trajs: List[Trajectory]) -> Dict[str, np.ndarray]:
        """One optimizer-step batch from B trajectories.

        Row i is prompt+generation left-aligned in S positions;
        ``labels[j] = seq[j+1]`` (next-token), ``mask[j] = 1`` iff the
        label at j is a *generated* token — prompt and pad positions
        carry zero weight and therefore zero gradient.  Advantages are
        batch-normalized rewards (REINFORCE with a mean baseline)."""
        S = self.spec.seq_len
        B = len(trajs)
        tokens = np.zeros((B, S), np.int32)
        labels = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        rew = np.array([t.reward for t in trajs], np.float32)
        for i, t in enumerate(trajs):
            seq = (list(t.prompt) + list(t.tokens))[:S + 1]
            L = len(seq)
            tokens[i, :L - 1] = seq[:-1]
            labels[i, :L - 1] = seq[1:]
            lo, hi = max(len(t.prompt) - 1, 0), L - 1
            mask[i, lo:hi] = 1.0
        adv = (rew - rew.mean()) / (rew.std() + 1e-6)
        return {"tokens": tokens, "labels": labels, "mask": mask,
                "advantages": adv.astype(np.float32)}

    # ------------------------------------------------------------------ drain
    def _drain(self, n: int, should_stop) -> Optional[List]:
        """Lease n fresh trajectories (heartbeating held leases while
        waiting); None if preempted mid-drain (held leases released)."""
        held: List = []
        deadline = time.monotonic() + self.spec.drain_timeout_s
        while len(held) < n:
            if should_stop is not None and should_stop():
                self.rollouts.release(held, worker=self.name)
                return None
            got = self.rollouts.take_fresh(
                n - len(held), worker=self.name,
                current_version=self.version,
                max_policy_lag=self.spec.max_policy_lag)
            held.extend(got)
            self.rollouts.renew(held, worker=self.name)
            if len(held) < n:
                if time.monotonic() > deadline:
                    self.rollouts.release(held, worker=self.name)
                    raise RuntimeError(
                        f"learner starved: {len(held)}/{n} trajectories "
                        f"after {self.spec.drain_timeout_s}s (actors dead?)")
                time.sleep(self.spec.drain_poll_s)
        return held

    # -------------------------------------------------------------- segments
    def run(self, should_stop=None) -> Dict[str, Any]:
        """One resumable segment.  Returns {"done": bool, "preempted":
        bool, "step": last_completed}."""
        spec, dev = self.spec, self.device
        K = max(spec.device_steps, 1)
        eff_ckpt = snap_cadence(spec.ckpt_every, K)
        eff_pub = snap_cadence(spec.broadcast_every, K)
        restored, meta = self.ckpt.restore_latest(self._abstract(), dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = int(meta["step"]) + 1
            self.version = int(meta.get("version", self.version))
            rewind_to = meta["queue"]
        else:
            params, opt = self._init_state()
            start = 0
            if self._queue_at_start is None:
                self._queue_at_start = self.rollouts.snapshot()
            rewind_to = self._queue_at_start
        self.report.steps_lost += max(0, self.report.steps_done - start)
        if self._crashed:
            self.rollouts.rewind(rewind_to)
            self._crashed = False
        seg = {"start": start, "end": start - 1, "outcome": "running"}
        self.report.segments.append(seg)

        def finish(outcome: str, step: int, *, goodbye: bool):
            seg["outcome"], seg["end"] = outcome, step
            if goodbye and step >= start:
                self.ckpt.wait()
                self.ckpt.save(step, {"params": params, "opt": opt},
                               extra=self._extra())
            self.ckpt.wait()
            return {"done": outcome == "done", "preempted":
                    outcome == "preempted", "step": step}

        step = start - 1
        for c_start, length in chunk_schedule(start, spec.steps, K):
            if should_stop is not None and should_stop():
                self.report.preemptions += 1
                return finish("preempted", step, goodbye=True)
            t0 = time.perf_counter()
            held = self._drain(length * spec.batch, should_stop)
            if held is None:
                self.report.preemptions += 1
                return finish("preempted", step, goodbye=True)
            t1 = time.perf_counter()
            steps_trajs = [[t for _, t in
                            held[i * spec.batch:(i + 1) * spec.batch]]
                           for i in range(length)]
            batches = [self.encode(trajs) for trajs in steps_trajs]
            stacked = {k: np.stack([b[k] for b in batches])
                       for k in batches[0]}
            params, opt, ms = steps_mod.rl_train_chunk(
                spec.cfg, spec.par, spec.ocfg, params, opt, stacked,
                device=dev)
            # one sync per chunk
            losses, norms = torch.stack([ms["loss"], ms["grad_norm"]]).cpu()
            self.report.drain_s.append(t1 - t0)
            self.report.chunk_s.append(time.perf_counter() - t1)
            self.report.host_syncs += 1
            self.report.losses.extend(losses.tolist())
            self.report.grad_norms.extend(norms.tolist())
            for trajs in steps_trajs:
                rewards = np.array([t.reward for t in trajs], np.float32)
                self.report.reward_mean.append(float(rewards.mean()))
                self.report.reward_std.append(float(rewards.std()))
            self.rollouts.ack_trained(held, worker=self.name,
                                      current_version=self.version)
            step = c_start + length - 1
            self.report.steps_done = max(self.report.steps_done, step + 1)
            if self.metrics is not None:
                self.metrics.gauge("rl/learner_step", step)
                self.metrics.gauge("rl/loss", float(losses[-1]))
            done = step + 1
            if eff_pub and done % eff_pub == 0 and done < spec.steps:
                self.version += 1
                self.policies.publish(self.version, params, step=done)
                self.report.publishes += 1
            if eff_ckpt and done % eff_ckpt == 0:
                self.ckpt.save_async(
                    step, {"params": params, "opt": opt},
                    extra=self._extra())
            if (spec.fail_at >= 0 and step >= spec.fail_at
                    and not self._failed_once):
                self._failed_once = self._crashed = True
                seg["outcome"], seg["end"] = "failed", step
                self.ckpt.wait()     # periodic save may be in flight
                raise InjectedLearnerFailure(
                    f"injected learner crash after step {step}")
        # final weights always published so actors converge on the last
        # version even when steps % broadcast_every != 0
        self.version += 1
        self.policies.publish(self.version, params, step=spec.steps)
        self.report.publishes += 1
        self.report.final_version = self.version
        return finish("done", step, goodbye=True)

    def _extra(self) -> dict:
        return {"version": self.version,
                "steps_done": self.report.steps_done,
                "queue": self.rollouts.snapshot()}

    def run_supervised(self, should_stop=None, *,
                       max_failures: int = 3) -> Dict[str, Any]:
        """The crash loop: resume through injected hard failures until
        the segment completes or is cooperatively preempted."""
        failures = 0
        while True:
            try:
                out = self.run(should_stop)
            except InjectedLearnerFailure:
                failures += 1
                self.report.recoveries += 1
                if failures > max_failures:
                    raise
                continue
            return out

"""Distributed RL workload: a serving-plane actor fleet feeding a
policy-gradient learner, ported from the JAX package's ``repro.rl``.

  * actors  — ``ServingEngine`` replicas (continuous batching, paged KV)
              leasing rollout tickets from one shared ``WorkQueue``;
  * replay  — a lease-heartbeat ``RolloutQueue`` of version-stamped
              trajectories (staleness-bounded by ``max_policy_lag``);
  * learner — chunks of optimizer steps with the advantage-weighted
              policy-gradient loss, checkpoint/resume;
  * weights — versioned ``PolicyStore`` broadcast (publish atomically,
              actors pull-on-version-bump).

``repro_torch.api.runners.run_rl_fleet`` wires them together.
"""
from repro_torch.rl.actor import ActorFleet, RolloutActor, default_reward
from repro_torch.rl.learner import (InjectedLearnerFailure, RLLearner,
                                    RLLearnerSpec, RLRunReport)
from repro_torch.rl.replay import (RolloutQueue, Trajectory, is_stale,
                                   split_stale, ticket_queue)
from repro_torch.rl.weights import PolicyStore

__all__ = [
    "ActorFleet", "RolloutActor", "default_reward",
    "InjectedLearnerFailure", "RLLearner", "RLLearnerSpec", "RLRunReport",
    "RolloutQueue", "Trajectory", "is_stale", "split_stale", "ticket_queue",
    "PolicyStore",
]

"""Workload declarations the port's drivers take.

The fields and defaults of the JAX package's ``api/resources.py``
``ServeJob`` and ``RLJob``, without their manifest validation and
without the tenant and fabric routing fields (``site``,
``learner_site``, ``devices``, ``min_devices``): the port has no
sessions, tenants or sites yet.  ``RLJob.from_manifest`` reads the
``spec`` of a JSON manifest (``examples/manifests/rl_smoke.json``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

API_VERSION = "repro/v1"


@dataclass(frozen=True)
class ServeJob:
    """Continuous-batching inference over a request queue; with
    ``max_replicas > 1`` replicas behind the router."""
    name: str
    arch: str = "phi4-mini-3.8b"
    smoke: bool = True
    n_requests: int = 8                 # synthetic stream when no requests
    prompt_len: int = 32
    max_new_tokens: int = 16
    slots: int = 4                      # decode-slot pool size
    seed: int = 0
    gen_lens: Optional[Tuple[int, ...]] = None   # heterogeneous stops
    lease_timeout: float = 30.0
    warmup: bool = False
    # explicit request stream: [{"id": ..., "prompt": [...], ...}, ...]
    requests: Optional[List[Dict[str, Any]]] = None
    # paged KV pool + prefix cache (None = auto when the family supports it)
    paged: Optional[bool] = None
    block_size: int = 8
    pool_blocks: Optional[int] = None
    prefix_cache: bool = True
    # min==max pins the fleet size; min<max enables the autoscaler
    min_replicas: int = 1
    max_replicas: int = 1
    target_backlog: float = 4.0         # autoscaler queue depth / replica
    ttft_slo_s: Optional[float] = None  # p99 service-TTFT scale-up trigger


@dataclass(frozen=True)
class RLJob:
    """Distributed RL: ``actors`` serving engines lease rollout tickets
    from one shared queue and push version-stamped trajectories; the
    learner drains ``rollouts_per_step`` a step, never trains on rollouts
    staler than ``max_policy_lag`` versions, and publishes weights every
    ``broadcast_every`` steps."""
    name: str
    learner_steps: int
    arch: str = "phi4-mini-3.8b"
    smoke: bool = True
    actors: int = 2                     # rollout fleet width
    rollouts_per_step: int = 2          # learner batch (trajectories/step)
    prompt_len: int = 8
    max_new_tokens: int = 8
    seq_len: int = 32                   # learner sequence budget
    slots: int = 2                      # decode-slot pool per actor
    max_policy_lag: int = 2             # bounded-staleness contract
    broadcast_every: int = 2            # learner steps between publishes
    ckpt_every: int = 2
    device_steps: int = 1               # optimizer steps a chunk
    keep: int = 3
    seed: int = 0
    fail_at: int = -1                   # inject ONE learner crash here
    lease_timeout: float = 30.0
    ckpt_dir: str = ""                  # "" = a throwaway directory
    # model / optimizer overrides (kwargs for ModelConfig / the schedule)
    config: Optional[Dict[str, Any]] = None
    optimizer: Optional[Dict[str, Any]] = None
    # paged KV pool on the actor engines
    paged: Optional[bool] = None
    block_size: int = 8
    pool_blocks: Optional[int] = None
    prefix_cache: bool = True

    @classmethod
    def from_manifest(cls, path: str) -> "RLJob":
        """The RLJob a JSON manifest declares."""
        with open(path) as f:
            man = json.load(f)
        if man.get("apiVersion", API_VERSION) != API_VERSION or \
                man.get("kind") != "RLJob":
            raise ValueError(f"{path}: not a {API_VERSION} RLJob manifest")
        return cls(name=man["metadata"]["name"], **man["spec"])

"""ChurnController — node-churn events in, rescale decisions out.

A copy of the JAX package's ``elastic/controller.py``.  Pure policy: given
the cluster's online device count it computes the mesh the trainer *should*
be on (``core.elastic.rescale_plan`` keeps every non-data axis fixed —
TP/EP layouts are weight-structural) and the accumulation plan that keeps
the global batch constant on it.  The trainer
asks two questions each supervision tick:

  * ``decide(active)`` — is a strictly larger mesh available now (nodes
    rejoined)?  If so, preempt gracefully and rebuild.
  * shrinking never needs polling: a failed node *drains* its pods
    (``Cluster.fail_node``), so the trainer observes the FAILED pod and
    calls ``decide(None)`` to plan the survivor mesh.

It also subscribes to the cluster's watcher hook so every fail/join event is
timestamped in the run report (observability, §VI).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from repro_torch.core.elastic import RescalePlan, rescale_plan
from repro_torch.core.orchestrator import Cluster
from repro_torch.elastic.batch import BatchPlan, batch_plan


class CapacityLostError(RuntimeError):
    """``wait_for_capacity`` exhausted its rejoin window: this cluster can
    no longer host even one model replica (e.g. a whole site unplugged).
    The single-cluster trainer cannot recover from this — it escalates to
    whoever owns more than one cluster (the JAX package's fabric failover
    answers by moving the job, with its checkpoints, to a surviving
    site)."""


@dataclass(frozen=True)
class Decision:
    """One controller verdict: the mesh+accum the trainer should run on."""
    plan: RescalePlan
    batch: BatchPlan

    @property
    def n_devices(self) -> int:
        return self.plan.devices_used


@dataclass
class ChurnEvent:
    kind: str                 # "fail" | "join"
    device: Any
    ts: float


class ChurnController:
    def __init__(self, cluster: Cluster, *, axes: Tuple[str, ...],
                 base_shape: Tuple[int, ...], global_batch: int,
                 max_data: Optional[int] = None):
        self.cluster = cluster
        self.axes = tuple(axes)
        self.base_shape = tuple(base_shape)
        self.global_batch = global_batch
        self.max_data = max_data
        self.events: List[ChurnEvent] = []
        self._lock = threading.Lock()
        # per-replica row budget: sized once for the *base* mesh at accum=1,
        # so any smaller mesh raises accumulation instead of its memory use
        i = self.axes.index("data")
        base_data = self.base_shape[i]
        if global_batch % base_data:
            raise ValueError(f"global_batch={global_batch} must tile the "
                             f"base data axis {base_data}")
        self.per_replica = global_batch // base_data
        # the data axis may grow past base_shape when spare nodes join, but
        # never past the largest power-of-two divisor of the global batch —
        # a bigger axis could not shard the batch evenly
        batch_cap = global_batch & -global_batch
        self._data_cap = batch_cap if max_data is None \
            else min(max_data, batch_cap)
        cluster.add_watcher(self._on_event)

    # ------------------------------------------------------------ events
    def _on_event(self, kind: str, device) -> None:
        with self._lock:
            self.events.append(ChurnEvent(kind, device, time.time()))

    # ---------------------------------------------------------- decisions
    def decide(self, active: Optional[Decision] = None) -> Optional[Decision]:
        """The mesh the current cluster supports, or None if unchanged.

        With ``active=None`` always returns a Decision (initial placement or
        post-failure replanning).  With an active Decision, returns a new one
        only when a strictly larger device set is usable — the grow trigger;
        a *smaller* plan is never volunteered here because shrink is driven
        by the drain path (the pod has already failed).
        """
        n = len(self.cluster.online_devices)
        plan = rescale_plan(self.axes, self.base_shape, n,
                            max_data=self._data_cap)
        if active is not None and plan.devices_used <= active.n_devices:
            return None
        i = self.axes.index("data")
        bp = batch_plan(self.global_batch, plan.new_shape[i],
                        per_replica=self.per_replica)
        return Decision(plan, bp)

    def wait_for_capacity(self, timeout: float,
                          poll: float = 0.05) -> Decision:
        """Block until enough nodes exist to host one model replica.

        Covers total-loss churn (every data-parallel rank dead): the paper's
        cluster keeps the Job pending until nodes rejoin; we bound the wait.
        """
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.decide(None)
            except RuntimeError as e:
                if time.monotonic() >= deadline:
                    raise CapacityLostError(
                        f"no capacity after {timeout:.0f}s: {e}") from e
                time.sleep(poll)

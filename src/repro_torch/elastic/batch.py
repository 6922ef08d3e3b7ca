"""Global-batch-invariant gradient accumulation.

A copy of the JAX package's ``elastic/batch.py``.  The elastic contract:
the optimizer trajectory must not depend on how many nodes happen to be
alive.  ``runtime.steps.train_step`` consumes the full global batch per
call and folds it into ``accum_steps`` microbatches, so the knob that
absorbs a mesh reshape is *accumulation*, not batch size:

    global_batch = microbatch x accum_steps            (constant)
    per-replica rows = microbatch / data_axis_size     (bounded by memory)

``batch_plan`` picks the smallest legal ``accum_steps`` for a given data-axis
size so that per-replica microbatch rows never exceed the budget the full
cluster was sized for — shrink the data axis 4 -> 2 and accumulation doubles,
grow it back and accumulation relaxes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class BatchPlan:
    global_batch: int
    data_size: int            # mesh data-axis size this plan is for
    accum_steps: int

    @property
    def microbatch(self) -> int:
        """Rows per microbatch (across the whole data axis)."""
        return self.global_batch // self.accum_steps

    @property
    def per_replica(self) -> int:
        """Rows per data-parallel replica per microbatch."""
        return self.microbatch // self.data_size

    def check(self) -> "BatchPlan":
        if self.microbatch * self.accum_steps != self.global_batch:
            raise ValueError(f"accum {self.accum_steps} does not divide "
                             f"global batch {self.global_batch}")
        if self.per_replica * self.data_size != self.microbatch:
            raise ValueError(f"data axis {self.data_size} does not divide "
                             f"microbatch {self.microbatch}")
        return self


def batch_plan(global_batch: int, data_size: int, *,
               per_replica: Optional[int] = None) -> BatchPlan:
    """Smallest accumulation keeping per-replica rows <= ``per_replica``.

    ``per_replica=None`` means "no memory bound": accumulation stays at 1
    (the full-cluster case).  Divisibility is enforced by stepping the
    accumulation UP from the bound's minimum — more accumulation only
    shrinks microbatches, so the memory bound is never overshot — until a
    value tiles both the global batch and the data axis; if none exists
    the shapes are simply incompatible and we raise rather than silently
    change the global batch.
    """
    if global_batch % data_size:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"data axis {data_size}")
    if per_replica is None:
        accum = 1
    else:       # ceil: G / (accum * data) <= per_replica
        accum = max(1, -(-global_batch // (per_replica * data_size)))
    while accum <= global_batch and (
            global_batch % accum or (global_batch // accum) % data_size):
        accum += 1
    if accum > global_batch:
        raise ValueError(
            f"no accumulation tiles global_batch={global_batch} over "
            f"data axis {data_size} within per_replica={per_replica}")
    return BatchPlan(global_batch, data_size, accum).check()

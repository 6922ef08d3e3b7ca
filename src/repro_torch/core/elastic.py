"""Elastic rescale plans — nodes join/leave, the logical mesh reshapes.

CHASE-CI §V: "nodes can join and leave the cluster at any time ... if a node
is taken offline the pods on that node will be rescheduled on another node".
A copy of ``RescalePlan`` and ``rescale_plan`` from the JAX package's
``core/elastic.py``: the data axis absorbs the change, every other axis
stays.  The port has no mesh (``make_elastic_mesh`` and ``reshard`` have no
counterpart): a training segment runs on one device, and the plan's data
axis only sets gradient accumulation through ``elastic.batch.BatchPlan``,
so a mesh change becomes an accumulation rescale.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class RescalePlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int
    devices_idle: int

    @property
    def data_parallel_change(self) -> float:
        i = self.axes.index("data")
        return self.new_shape[i] / self.old_shape[i]


def rescale_plan(axes: Tuple[str, ...], old_shape: Tuple[int, ...],
                 n_devices: int, *,
                 max_data: Optional[int] = None) -> RescalePlan:
    """Largest mesh for `n_devices` keeping every non-data axis fixed.

    The data axis absorbs the change (standard elastic-DP policy); if fewer
    devices than one model replica exist, raise — that cluster cannot host
    the model at all.  ``max_data`` caps the data axis (e.g. a launcher that
    wants a fixed single-device layout regardless of spare devices).
    """
    i = axes.index("data")
    fixed = int(np.prod([s for j, s in enumerate(old_shape) if j != i]))
    if n_devices < fixed:
        raise RuntimeError(
            f"{n_devices} devices < one model replica ({fixed})")
    new_data = n_devices // fixed
    # keep power-of-two data axis for even batch sharding
    new_data = 1 << (new_data.bit_length() - 1)
    if max_data is not None:
        new_data = min(new_data, max_data)
    new_shape = tuple(new_data if j == i else s
                      for j, s in enumerate(old_shape))
    used = fixed * new_data
    return RescalePlan(tuple(old_shape), new_shape, tuple(axes),
                       used, n_devices - used)

"""Elastic rescale plans — nodes join/leave, the logical mesh reshapes.

CHASE-CI §V: "nodes can join and leave the cluster at any time ... if a node
is taken offline the pods on that node will be rescheduled on another node".
A copy of ``RescalePlan`` and ``rescale_plan`` from the JAX package's
``core/elastic.py``: the data axis absorbs the change, every other axis
stays.  ``make_elastic_mesh`` is the counterpart of the reference's: a
plan over the leased slots gives the plan's ``launch.mesh.Mesh`` and one
rank device a slot, rank r at the r-th slot in row-major order, as
``np.array(devs[:n]).reshape(shape)`` lays the reference's devices out.
A segment of the elastic trainer on ranks runs one process a slot on that
mesh and restores the newest checkpoint onto it (the checkpointer is
mesh-agnostic), so a lost node costs one restore onto a reshaped mesh.
On one device (a cluster whose slots are not ranks) the plan's data axis
only sets gradient accumulation through ``elastic.batch.BatchPlan``.
``reshard`` has no counterpart: it moves arrays between shardings within
one process, and the trainer never calls it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, make_mesh


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


def _names_device(slot) -> bool:
    return isinstance(slot, torch.device) or (
        isinstance(slot, str) and slot.split(":")[0] in ("cuda", "cpu"))


def make_elastic_mesh(plan: RescalePlan, devices: Sequence[Any], *,
                      compute="cuda",
                      named: Optional[Mapping[Any, Any]] = None
                      ) -> Tuple[Mesh, List[str]]:
    """The plan's mesh over the first ``prod(plan.new_shape)`` leased slots
    ``devices`` and the device of each one's rank, in slot order (rank r
    on slot r, row-major).  A slot's device is ``named[slot]`` where the
    caller names it, else the slot itself where it names a CUDA or CPU
    device; a logical slot (``"slot3"``) ranks on ``compute``: the CPU,
    or card r for rank r, which raises where the ranks outnumber the
    cards (name the devices to put several ranks on one card)."""
    n = int(np.prod(plan.new_shape))
    slots = list(devices)[:n]
    if len(slots) < n:
        raise ValueError(f"a mesh of {plan.new_shape} needs {n} slots, "
                         f"{len(slots)} are leased")
    kind = resolve_device(compute).type
    out = []
    for r, slot in enumerate(slots):
        if named is not None and slot in named:
            dev = torch.device(named[slot])
        elif _names_device(slot):
            dev = torch.device(slot)
        elif kind == "cpu":
            dev = torch.device("cpu")
        else:
            cards = torch.cuda.device_count()
            if r >= cards:
                raise RuntimeError(
                    f"a mesh of {plan.new_shape} needs {n} cards, this host "
                    f"has {cards}; name each slot's device to put several "
                    f"ranks on one card (over gloo)")
            dev = torch.device("cuda", r)
        out.append(str(dev))
    return make_mesh(plan.new_shape, plan.axes), out

"""Production meshes, as descriptions.

The reference lowers its dry run onto 256 or 512 placeholder host devices
laid out as a ``jax.sharding.Mesh``.  One card hosts no such process
group, so the port's mesh is what the sharding rules and the dry run read
of one: the ordered axis names and their sizes.  It is not a
``torch.distributed`` mesh and starts no process.

    make_production_mesh().shape       # {"data": 16, "model": 16}
    make_production_mesh(multi_pod=True).shape
    # -> {"pod": 2, "data": 16, "model": 16}
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

# the fleet layouts the dry run counts bytes on
PRODUCTION_MESH_SHAPE = (16, 16)
PRODUCTION_MESH_SHAPE_MULTI_POD = (2, 16, 16)


@dataclass(frozen=True)
class Mesh:
    """Ordered mesh axes and their sizes; ``shape`` maps name -> size in
    axis order, as ``jax.sharding.Mesh.shape`` does."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} "
                             f"differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be positive: {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def tag(self) -> str:
        """``16x16`` / ``2x16x16``: the dry run's file-name suffix."""
        return "x".join(str(n) for n in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = PRODUCTION_MESH_SHAPE_MULTI_POD if multi_pod \
        else PRODUCTION_MESH_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """Any mesh (the tests use (4, 2); one card is ``single_device_mesh``)."""
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def single_device_mesh(axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """Every axis of size 1: each tensor whole on the one card."""
    return make_mesh((1,) * len(axes), axes)


def mesh_num_chips(mesh: Mesh) -> int:
    return int(math.prod(mesh.sizes))

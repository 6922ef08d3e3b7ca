"""Meshes: descriptions, and the process groups of a rank on one.

``Mesh`` is what the sharding rules and the dry run read of a mesh: the
ordered axis names and their sizes.  The reference lowers its dry run onto
256 or 512 placeholder host devices laid out as a ``jax.sharding.Mesh``;
the port counts bytes on the description alone, which starts no process.

``RankMesh`` is one process's place on a mesh that runs: after
``torch.distributed`` is initialised with one process a rank
(``launch.ranks.run_ranks``), ``make_rank_mesh`` lays the ranks out
row-major over the axes, as ``np.array(jax.devices()).reshape(shape)``
lays out the reference's devices, and builds this rank's subgroup along
each axis (``groups["data"]``: the ranks that differ from it in the data
coordinate alone).  ``RankMesh.from_rank0`` hands rank 0's few integers
to every rank (the step a restore picks, a segment's stop).

    make_production_mesh().shape       # {"data": 16, "model": 16}
    make_production_mesh(multi_pod=True).shape
    # -> {"pod": 2, "data": 16, "model": 16}
    rm = make_rank_mesh((2, 2), device)  # in each of 4 ranks
    rm.coords                          # rank 3: {"data": 1, "model": 1}
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

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


@dataclass(frozen=True)
class RankMesh:
    """This rank on a running mesh: the description, its coordinates, its
    device, the world group and one subgroup per axis (``groups[axis]``
    spans the ranks whose other coordinates equal this rank's)."""
    mesh: Mesh
    rank: int
    coords: Dict[str, int]
    device: torch.device
    world: Any
    groups: Dict[str, Any]

    def size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    @property
    def world_size(self) -> int:
        return mesh_num_chips(self.mesh)

    def group_of(self, axes: Tuple[str, ...]):
        """The group of the ranks that differ from this one along ``axes``
        alone, in the order of a dimension split over ``axes`` (major to
        minor, ``sharding.specs.shard_slices``): one axis's subgroup, or
        the world for every axis in the mesh's order, whose row-major
        ranks are the blocks' indices."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes == tuple(self.mesh.axis_names):
            return self.world
        raise NotImplementedError(
            f"a dimension split over {axes} on a mesh of "
            f"{self.mesh.axis_names}: no one group holds its blocks")

    def from_rank0(self, values) -> list:
        """Rank 0's ``values`` (non-negative ints) on every rank: one
        all-reduce over the world on this rank's device, which NCCL and
        gloo both take (a control message, never counted in
        ``sharding.collectives.bytes_sent``)."""
        import torch.distributed as dist
        t = torch.tensor(list(values) if self.rank == 0 else
                         [0] * len(values), dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, group=self.world)
        return [int(v) for v in t.tolist()]

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank calls it)."""
        import torch.distributed as dist
        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, group=self.world)
        return bool(t.item())


def make_rank_mesh(shape: Tuple[int, ...], device,
                   axes: Tuple[str, ...] = ("data", "model")) -> RankMesh:
    """This rank's ``RankMesh`` on an initialised default process group
    of ``prod(shape)`` ranks.  Every rank must call it, in the same order
    as its other ``new_group`` calls: each subgroup is built by all."""
    import torch.distributed as dist
    mesh = make_mesh(shape, axes)
    world = dist.get_world_size()
    if world != mesh_num_chips(mesh):
        raise ValueError(f"mesh {mesh.tag} needs {mesh_num_chips(mesh)} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    # row-major: rank r sits at everyone[r]
    everyone = list(itertools.product(*(range(n) for n in mesh.sizes)))
    coords = everyone[rank]
    groups = {}
    for i, axis in enumerate(axes):
        # one group per line along axis i, built in the same order on all
        # ranks; this rank keeps the one through its own coordinates
        lines = sorted({c[:i] + c[i + 1:] for c in everyone})
        for rest in lines:
            members = [r for r, c in enumerate(everyone)
                       if c[:i] + c[i + 1:] == rest]
            group = dist.new_group(members)
            if rest == coords[:i] + coords[i + 1:]:
                groups[axis] = group
    return RankMesh(mesh=mesh, rank=rank, coords=dict(zip(axes, coords)),
                    device=torch.device(device), world=dist.group.WORLD,
                    groups=groups)

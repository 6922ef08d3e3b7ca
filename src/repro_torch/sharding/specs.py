"""Logical-axis -> mesh-axis rules (MaxText-style), divisibility-aware.

A logical axis names *what* a tensor dimension is; the rules decide *where*
it lives on the mesh.  Rules silently drop to replication when the dimension
size does not divide the mesh axis (e.g. 24 q-heads on a 16-way model axis,
8 kv-heads on 16): padded shards would waste memory, so divisible-only
keeps the byte counts honest.

The rules and ``spec_for`` are the JAX package's ``sharding/specs.py``,
entry for entry; a spec is a tuple with one entry a dimension, each None,
a mesh axis name or a tuple of names, as ``jax.sharding.PartitionSpec``
holds them.  The dry run (``launch.dryrun``) reads these specs to count
each tensor's bytes per device of a production mesh (``shard_shape``),
one leaf at a time, so the reference's tree helpers
(``shardings_for_schema``, ``shardings_like``) have no counterpart.  On a
running mesh (``launch.mesh.RankMesh``) a rank holds the block of each
leaf that ``local_shard`` cuts, the block ``shard_shape`` counts for its
device; ``assemble`` puts the blocks of every rank back together.  The
reference's ``constrain`` has no counterpart: the port's train step lays
out its activations by hand (``runtime.steps``, ``models.moe``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import PSpec, tree_map_schema

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]


def logical_rules(par: ParallelConfig) -> Dict[str, Axis]:
    """Active logical->mesh mapping for a ParallelConfig."""
    if par.pure_fsdp:
        return {
            # batch over every mesh axis; weights ZeRO-3 over (data, model);
            # no tensor/sequence parallelism -> zero activation collectives
            "batch": ("pod", "data", "model"),
            "seq": None, "act_seq_sharded": None,
            "heads": None, "kv_heads": None, "act_ff": None,
            "act_vocab": None, "act_inner_heads": None,
            "cache_seq": "model" if par.context_parallel_decode else None,
            "head_dim": None, "state": None,
            "fsdp": ("data", "model"), "tp_heads": None, "tp_kv_heads": None,
            "tp_head_dim": None, "tp_ff": None, "tp_vocab": None,
            "expert": None, "tp_inner": None, "tp_inner_heads": None,
            "layers": None, "conv_k": None,
        }
    rules: Dict[str, Axis] = {
        # --- activations ---
        "batch": ("pod", "data"),
        "seq": None,
        "act_seq_sharded": "model" if par.sequence_parallel else None,
        "heads": "model" if par.tensor_parallel else None,
        "kv_heads": "model" if par.tensor_parallel else None,
        "act_ff": "model" if par.tensor_parallel else None,
        "act_vocab": "model" if par.tensor_parallel else None,
        "cache_seq": "model" if par.context_parallel_decode else None,
        "head_dim": None,
        "state": None,
        "act_inner_heads": "model" if par.tensor_parallel else None,
        # --- params ---
        "fsdp": "data" if par.fsdp else None,
        "tp_heads": "model" if par.tensor_parallel else None,
        "tp_kv_heads": "model" if par.tensor_parallel else None,
        "tp_head_dim": "model" if par.tensor_parallel else None,
        "tp_ff": "model" if par.tensor_parallel else None,
        "tp_vocab": "model" if par.tensor_parallel else None,
        "expert": "model" if par.expert_parallel else None,
        "tp_inner": "model" if par.tensor_parallel else None,
        "tp_inner_heads": "model" if par.tensor_parallel else None,
        "layers": None,
        "conv_k": None,
    }
    return rules


def _mesh_size(mesh: Mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    shape = mesh.shape
    if isinstance(axis, str):
        return shape.get(axis, 1)
    n = 1
    for a in axis:
        n *= shape.get(a, 1)
    return n


def _present(mesh: Mesh, axis: Axis) -> Axis:
    """Restrict a rule to axes present in the mesh (pod may be absent)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh.shape else None
    kept = tuple(a for a in axis if a in mesh.shape)
    return kept if len(kept) > 1 else (kept[0] if kept else None)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh: Mesh, rules: Dict[str, Axis]) -> Spec:
    """The spec of one tensor, dropping non-divisible rules.

    Tuple rules degrade gracefully: ("pod","data","model") that does not
    divide the dim retries without its leading axis before replicating.
    """
    entries = []
    used: set = set()
    for dim, name in zip(shape, axes):
        axis = _present(mesh, rules.get(name)) if name else None
        if axis is not None:
            candidates = [axis]
            if isinstance(axis, tuple):
                candidates += [axis[i:] if len(axis[i:]) > 1 else axis[-1]
                               for i in range(1, len(axis))]
            chosen = None
            for cand in candidates:
                flat = (cand,) if isinstance(cand, str) else cand
                if (not any(a in used for a in flat)
                        and dim % _mesh_size(mesh, cand) == 0):
                    chosen = cand
                    used.update(flat)
                    break
            axis = chosen
        entries.append(axis)
    return tuple(entries)


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` laid out by ``spec``
    (dimensions past the spec's entries are whole)."""
    out = []
    for i, dim in enumerate(shape):
        n = _mesh_size(mesh, spec[i]) if i < len(spec) else 1
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"into {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)



def _flat(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the device at ``coords``
    holds under ``spec``.  A dimension split over a tuple of axes counts
    them major to minor, as a ``PartitionSpec`` does."""
    block = shard_shape(shape, spec, mesh)
    out = []
    for i, n in enumerate(block):
        idx = 0
        for a in _flat(spec[i] if i < len(spec) else None):
            idx = idx * mesh.shape.get(a, 1) + coords.get(a, 0)
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The device at ``coords``'s block of the whole tensor ``t``, as a
    contiguous copy."""
    return t[shard_slices(t.shape, spec, mesh, coords)].contiguous()


def assemble(blocks: Mapping[Tuple[int, ...], torch.Tensor],
             shape: Sequence[int], spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the blocks of ``local_shard``, keyed by each
    device's coordinates in ``mesh.axis_names`` order (replicas must
    agree; the last one written stands)."""
    first = next(iter(blocks.values()))
    out = torch.empty(tuple(shape), dtype=first.dtype, device=first.device)
    for coords, block in blocks.items():
        at = dict(zip(mesh.axis_names, coords))
        out[shard_slices(shape, spec, mesh, at)] = block
    return out


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dimension ``spec`` splits over mesh axis ``axis``, or None."""
    for i, entry in enumerate(spec):
        if axis in _flat(entry):
            return i
    return None


def rule_axes(rules: Dict[str, Axis], name: str, mesh: Mesh
              ) -> Tuple[str, ...]:
    """The mesh axes logical axis ``name`` maps to on ``mesh``, major to
    minor (the batch over ``("data", "model")`` under pure FSDP)."""
    return _flat(_present(mesh, rules.get(name)))


def split_axes(spec: Spec) -> Dict[int, Tuple[str, ...]]:
    """Each dimension ``spec`` splits, and the mesh axes it splits it
    over, major to minor."""
    return {i: _flat(entry) for i, entry in enumerate(spec) if entry}


def replicas(spec: Spec, mesh: Mesh) -> int:
    """How many devices of ``mesh`` hold each block under ``spec``."""
    split = 1
    for entry in spec:
        split *= _mesh_size(mesh, entry)
    n = 1
    for size in mesh.sizes:
        n *= size
    return n // split


def leaf_specs(schema, mesh: Mesh, rules: Dict[str, Axis]):
    """The spec of every leaf of a ``PSpec`` schema, in its structure."""
    return tree_map_schema(
        lambda _path, p: spec_for(p.shape, p.axes, mesh, rules), schema)


def local_schema(schema, mesh: Mesh, rules: Dict[str, Axis]):
    """``schema`` with every leaf's shape cut to one device's block."""
    return tree_map_schema(
        lambda _path, p: PSpec(
            shard_shape(p.shape, spec_for(p.shape, p.axes, mesh, rules),
                        mesh), p.axes, p.init, p.scale, p.dtype), schema)

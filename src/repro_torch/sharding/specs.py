"""Logical-axis -> mesh-axis rules (MaxText-style), divisibility-aware.

A logical axis names *what* a tensor dimension is; the rules decide *where*
it lives on the mesh.  Rules silently drop to replication when the dimension
size does not divide the mesh axis (e.g. 24 q-heads on a 16-way model axis,
8 kv-heads on 16): padded shards would waste memory, so divisible-only
keeps the byte counts honest.

The rules and ``spec_for`` are the JAX package's ``sharding/specs.py``,
entry for entry; a spec is a tuple with one entry a dimension, each None,
a mesh axis name or a tuple of names, as ``jax.sharding.PartitionSpec``
holds them.  On one card nothing is partitioned: the dry run
(``launch.dryrun``) reads these specs to count each tensor's bytes per
device of a production mesh (``shard_shape``), one leaf at a time, so the
reference's tree helpers (``shardings_for_schema``, ``shardings_like``)
have no counterpart.  Nor has its ``constrain``: on one device it is a
no-op, and the port's models never call it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import Mesh

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


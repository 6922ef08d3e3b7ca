"""Single-source-of-truth parameter schemas, in PyTorch.

A model's parameters are described once as a nested dict of ``PSpec``
(shape + logical axes + init), exactly as in the JAX package, so leaf
paths and shapes match the reference one to one.  ``init_params``
materialises a schema with the same init rules; the random numbers come
from an explicit ``torch.Generator`` and so differ from ``jax.random``
(tests carry JAX-made params over through ``repro_torch.bridge``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # stddev override for "normal"
    dtype: Optional[str] = None       # override model param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_schema(fn, schema, path: str = ""):
    """Map fn(path, PSpec) over a schema, preserving structure.

    Plain recursion, not a nested closure: a closure that calls itself is a
    reference cycle, which would keep ``fn`` (and the tensors it closes
    over, such as ``init_params``'s leaves) alive until the next garbage
    collection."""
    if isinstance(schema, PSpec):
        return fn(path, schema)
    return {k: tree_map_schema(fn, v, f"{path}/{k}" if path else k)
            for k, v in schema.items()}


def leaves(schema) -> list[tuple[str, PSpec]]:
    """(path, PSpec) pairs in sorted-path order (the JAX key order)."""
    out: list[tuple[str, PSpec]] = []
    tree_map_schema(lambda path, p: out.append((path, p)), schema)
    return sorted(out, key=lambda kv: kv[0])


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _init_one(p: PSpec, generator: torch.Generator, dtype: str,
              device) -> torch.Tensor:
    dt = torch_dtype(p.dtype or dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dt)


def init_params(schema, generator: torch.Generator, dtype: str, device):
    """Materialise ``schema`` on ``device``: zeros/ones as named, normal
    leaves with std = ``scale`` or 1/sqrt(fan_in), drawn in f32 from
    ``generator`` (which must live on ``device``) in sorted-path order."""
    out = {}
    for path, p in leaves(schema):
        out[path] = _init_one(p, generator, dtype, device)
    return tree_map_schema(lambda path, _p: out[path], schema)


def abstract_params(schema, dtype: str):
    """``meta`` tensors of the schema's shapes and dtypes (``dtype`` where a
    leaf names none): shapes and bytes with no memory behind them, the
    counterpart of the reference's ``ShapeDtypeStruct`` tree."""
    return tree_map_schema(
        lambda _path, p: torch.empty(p.shape,
                                     dtype=torch_dtype(p.dtype or dtype),
                                     device="meta"), schema)


def axes_tree(schema):
    """The logical axes of each leaf, in the schema's structure."""
    return tree_map_schema(lambda _path, p: p.axes, schema)


def param_count(schema) -> int:
    return int(sum(math.prod(p.shape) for _, p in leaves(schema)))


def param_bytes(schema, dtype: str) -> int:
    return int(sum(math.prod(p.shape) * torch_dtype(p.dtype or dtype).itemsize
                   for _, p in leaves(schema)))

"""AdamW over a parameter tree, in place, through the fused kernel.

A port of the JAX package's ``optim/adamw.py`` for the float32/full state
recipe: the optimizer state is schema-described like the params
(``opt_state_schema``), gradients are clipped by their f32-accumulated
global norm, and every leaf goes through the port's fused AdamW
(``repro_torch.kernels.adamw_update``: the CUDA kernel on the card, its
plain version on the CPU).  ``apply_updates`` updates params, ``m`` and
``v`` in place and returns the same tensors.

Weight decay follows the reference's documented rule, "only on leaves with
ndim >= 2", as its unfused path (the one its CPU runs take) decides it: a
leaf stacked over layers (leading axis "layers", G > 1) is judged by its
per-layer slice, so the stacked norm scales (G, D) get no decay.  The
reference's fused TPU path judges the whole (G, D) leaf and decays them
(ROADMAP queue C).

Not ported yet: ``moment_dtype`` bfloat16/int8 (``optim/quant.py``) and
``second_moment="factored"``; they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.adamw_update import adamw_update
from repro_torch.models.params import PSpec, leaves, tree_map_schema
from repro_torch.optim.schedule import learning_rate


def _check_recipe(ocfg: OptimizerConfig) -> None:
    if ocfg.moment_dtype != "float32":
        raise NotImplementedError(
            f"moment_dtype={ocfg.moment_dtype!r}: quantized moments "
            f"(optim/quant.py) are not ported yet (ROADMAP queue A, item 3)")
    if ocfg.second_moment != "full":
        raise NotImplementedError(
            f"second_moment={ocfg.second_moment!r}: the factored second "
            f"moment is not ported yet (ROADMAP queue A, item 3)")


def opt_state_schema(param_schema, ocfg: OptimizerConfig) -> Dict[str, Any]:
    """{"m": f32 tree like the params, "v": the same, "count": int32 ()}."""
    _check_recipe(ocfg)

    def moment(_path, p: PSpec) -> PSpec:
        return PSpec(p.shape, p.axes, "zeros", dtype="float32")

    return {"m": tree_map_schema(moment, param_schema),
            "v": tree_map_schema(moment, param_schema),
            "count": PSpec((), (), "zeros", dtype="int32")}


def decays(spec: PSpec) -> bool:
    """Weight decay on this leaf?  ndim >= 2 of the per-layer slice for a
    leaf stacked over G > 1 layers, of the whole leaf otherwise."""
    layered = (bool(spec.axes) and spec.axes[0] == "layers"
               and len(spec.shape) >= 2 and spec.shape[0] > 1)
    return len(spec.shape) - int(layered) >= 2


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over the leaves, accumulated in f32 without an
    f32 copy of any leaf.  No host sync."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(g, dtype=torch.float32).square()
        for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every leaf by min(1, max_norm / norm), in place and in the
    grad's own dtype; returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def apply_updates(param_schema, params, grads, state, ocfg: OptimizerConfig):
    """One AdamW step, in place.  Returns (params, state, stats).

    ``grads`` is a tree like ``params`` (param dtype or f32) and is
    clipped in place.  ``state["count"]`` is replaced by count + 1;
    ``stats`` holds the pre-clip ``grad_norm`` and this step's ``lr``,
    both f32 tensors on the params' device.
    """
    _check_recipe(ocfg)
    flat_p, flat_m, flat_v = _flat(params), _flat(state["m"]), _flat(state["v"])
    flat_g = {k: g.contiguous() for k, g in _flat(grads).items()}
    if ocfg.grad_clip:
        flat_g, gnorm = clip_by_global_norm(flat_g, ocfg.grad_clip)
    else:
        gnorm = global_norm(flat_g)
    count = state["count"] + 1
    lr = learning_rate(ocfg, count)
    t = count.to(torch.float32)
    bc1 = 1.0 - ocfg.b1 ** t
    bc2 = 1.0 - ocfg.b2 ** t
    scalars = torch.stack([lr, bc1, bc2]).to(torch.float32).contiguous()
    for path, spec in leaves(param_schema):
        wd = ocfg.weight_decay if decays(spec) else 0.0
        adamw_update(flat_p[path], flat_g[path], flat_m[path], flat_v[path],
                     scalars, b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
                     weight_decay=wd)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

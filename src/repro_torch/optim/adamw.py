"""AdamW over a parameter tree, in place, with the memory recipes.

A port of the JAX package's ``optim/adamw.py``: the optimizer state is
schema-described like the params (``opt_state_schema``), gradients are
clipped by their f32-accumulated global norm, and ``apply_updates`` updates
params and moments in place and returns the same tensors.  The recipes:

  moment_dtype:  float32 | bfloat16 | int8 (blockwise, ``optim.quant``:
                 a moment is ``{"q": int8, "s": f32 scales}``)
  second_moment: full | factored (Adafactor's row and column means
                 ``{"vr", "vc"}`` in f32, for a leaf whose per-layer slice
                 has at least 2 dims and which holds at least 2**16
                 elements; other leaves keep a ``moment_dtype`` moment)

A leaf whose ``m`` and ``v`` are both f32 tensors goes through the fused
AdamW (``repro_torch.kernels.adamw_update``: the CUDA kernel on the card,
its plain version on the CPU), as the reference's fused rule routes them.
Every quantized, bf16 or factored leaf takes the reference's plain leaf
math (``_update_block``: ``g**2 + 1e-30`` under the factored means, ``vr``
normalised by its mean), in PyTorch: the reference computes it in XLA,
outside any Pallas kernel.  A leaf stacked over G > 1 layers is walked one
layer slice at a time, as the reference's ``lax.scan`` walks it.  Each
slice is then walked in blocks of whole matrices of its leading axes, as
many as ``BLOCK_ELEMS`` holds and at least one, so an expert slice's f32
temps stay near 256 MB (kimi's is 64 matrices of 7168 x 2048, 0.94 B
elements: four a block).  That is exact: quant blocks run along the last
axis and the factored means are per matrix.  A matrix larger than a block
goes whole: kimi's tied (163,840, 7168) embedding makes f32 temps of 4.7
GB, and its training cut (2 layers, 64 experts) peaked at 68.43 GB on an
H100 80GB HBM3 at 700 W all the same (``chip_smoke.py``'s kimi phase
prints the peak; row blocks of that matrix held it to 40.25 GB).

Weight decay follows the reference's documented rule, "only on leaves with
ndim >= 2", as its unfused path (the one its CPU runs take) decides it: a
leaf stacked over layers (leading axis "layers", G > 1) is judged by its
per-layer slice, so the stacked norm scales (G, D) get no decay.  The
reference's fused TPU path judges the whole (G, D) leaf and decays them
(ROADMAP queue C).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.adamw_update import adamw_update
from repro_torch.models.params import PSpec, leaves, tree_map_schema
from repro_torch.optim import quant
from repro_torch.optim.schedule import learning_rate
from repro_torch.sharding import collectives

BLOCK_ELEMS = 1 << 26     # elements a block of the plain update walks

MOMENT_DTYPES = ("float32", "bfloat16", "int8")
SECOND_MOMENTS = ("full", "factored")


# ---------------------------------------------------------------------------
# state schema
# ---------------------------------------------------------------------------

def _check_recipe(ocfg: OptimizerConfig) -> None:
    if ocfg.moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype={ocfg.moment_dtype!r}: one of "
                         f"{MOMENT_DTYPES}")
    if ocfg.second_moment not in SECOND_MOMENTS:
        raise ValueError(f"second_moment={ocfg.second_moment!r}: one of "
                         f"{SECOND_MOMENTS}")


def _moment_schema(p: PSpec, ocfg: OptimizerConfig):
    if ocfg.moment_dtype == "int8":
        _, s_shape = quant.quantized_shapes(p.shape)
        s_axes = p.axes[:-1] + (None,) if p.shape else p.axes
        return {"q": PSpec(p.shape, p.axes, "zeros", dtype="int8"),
                "s": PSpec(s_shape, s_axes[:len(s_shape)], "zeros",
                           dtype="float32")}
    return PSpec(p.shape, p.axes, "zeros", dtype=ocfg.moment_dtype)


def _second_moment_schema(p: PSpec, ocfg: OptimizerConfig):
    # Factor the last two dims only when the per-layer slice is >= 2-D (a
    # stacked (G, D) norm scale is effectively 1-D) and the whole leaf
    # holds at least 2**16 elements, as the reference decides.
    layered = bool(p.axes) and p.axes[0] == "layers"
    eff_ndim = len(p.shape) - (1 if layered else 0)
    if (ocfg.second_moment == "factored" and eff_ndim >= 2
            and math.prod(p.shape) >= (1 << 16)):
        return {"vr": PSpec(p.shape[:-1], p.axes[:-1], "zeros",
                            dtype="float32"),
                "vc": PSpec(p.shape[:-2] + (p.shape[-1],),
                            p.axes[:-2] + (p.axes[-1],), "zeros",
                            dtype="float32")}
    return _moment_schema(p, ocfg)


def opt_state_schema(param_schema, ocfg: OptimizerConfig) -> Dict[str, Any]:
    """{"m": a moment a leaf, "v": a second moment a leaf, "count": int32
    ()}, the reference's schema: f32 or bf16 PSpecs, {"q", "s"} dicts
    under int8, {"vr", "vc"} dicts where the second moment is factored."""
    _check_recipe(ocfg)
    return {"m": tree_map_schema(lambda _p, p: _moment_schema(p, ocfg),
                                 param_schema),
            "v": tree_map_schema(lambda _p, p: _second_moment_schema(p, ocfg),
                                 param_schema),
            "count": PSpec((), (), "zeros", dtype="int32")}


def decays(spec: PSpec) -> bool:
    """Weight decay on this leaf?  ndim >= 2 of the per-layer slice for a
    leaf stacked over G > 1 layers, of the whole leaf otherwise."""
    return len(spec.shape) - int(_layered(spec)) >= 2


def _layered(spec: PSpec) -> bool:
    return (bool(spec.axes) and spec.axes[0] == "layers"
            and len(spec.shape) >= 2 and spec.shape[0] > 1)


# ---------------------------------------------------------------------------
# the plain leaf math, in place, block by block
# ---------------------------------------------------------------------------

def _is_quant(m) -> bool:
    return isinstance(m, dict) and "q" in m


def _is_factored(v) -> bool:
    return isinstance(v, dict) and "vr" in v


def _load(m) -> torch.Tensor:
    return quant.dequantize(m) if _is_quant(m) else m.to(torch.float32)


def _store(val: torch.Tensor, like) -> None:
    if _is_quant(like):
        qs = quant.quantize(val)
        like["q"].copy_(qs["q"])
        like["s"].copy_(qs["s"])
    else:
        like.copy_(val)


def _as3(t: torch.Tensor, last: int) -> torch.Tensor:
    """A view of a leaf slice as (E, R, last): E the product of the axes
    before the last two, R the second-to-last (1 for a 0-d or 1-D
    slice)."""
    R = t.shape[-2] if t.dim() >= 2 else 1
    return t.view(-1, R, last)


def _moment3(m, shape):
    """``m`` (a tensor or {"q", "s"}) viewed as ``_as3`` of ``shape``."""
    C = shape[-1] if shape else 1
    if _is_quant(m):
        nb = quant.quantized_shapes(shape)[1][-1] if shape else 1
        return {"q": _as3(m["q"], C), "s": _as3(m["s"], nb)}
    return _as3(m, C)


def _sub(m, es):
    if isinstance(m, dict):
        return {k: v[es] for k, v in m.items()}
    return m[es]


def _blocks(E: int, R: int, C: int):
    """Blocks of whole matrices of an (E, R, C) view: as many as
    ``BLOCK_ELEMS`` elements hold, and at least one."""
    eb = max(1, BLOCK_ELEMS // (R * C))
    for e0 in range(0, E, eb):
        yield slice(e0, e0 + eb)


def _factored_moments(g3, vr, vc, b2: float):
    """The new factored second moment of an (E, R, C) grad, into ``vr``
    (E, R) and ``vc`` (E, C) in place: ``b2 v + (1 - b2) mean(g**2 +
    1e-30)`` over the last axis and over the rows.  Returns ``r = vr /
    mean(vr)`` per matrix, (E, R)."""
    for es in _blocks(*g3.shape):
        g2 = torch.square(g3[es].to(torch.float32)) + 1e-30
        vr[es] = b2 * vr[es] + (1.0 - b2) * torch.mean(g2, dim=-1)
        vc[es] = b2 * vc[es] + (1.0 - b2) * torch.mean(g2, dim=-2)
    return vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)


def _update_block(p, g, m, v, v_hat, lr, bc1, bc2, ocfg: OptimizerConfig,
                  wd: float) -> None:
    """The reference's ``_update_leaf`` on one block, written back in
    place: ``v_hat`` is the factored estimate, or None to update ``v``."""
    g = g.to(torch.float32)
    m_new = ocfg.b1 * _load(m) + (1.0 - ocfg.b1) * g
    if v_hat is None:
        v_hat = ocfg.b2 * _load(v) + (1.0 - ocfg.b2) * torch.square(g)
        _store(v_hat, v)
    update = (m_new / bc1) / (torch.sqrt(v_hat / bc2) + ocfg.eps)
    if wd:
        update = update + wd * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
    _store(m_new, m)


def _update_slice(p, g, m, v, lr, bc1, bc2, ocfg: OptimizerConfig,
                  wd: float) -> None:
    """One leaf slice (a layer's, or a whole unstacked leaf), in place."""
    shape = tuple(p.shape)
    C = shape[-1] if shape else 1
    p3, g3 = _as3(p, C), _as3(g, C)
    m3 = _moment3(m, shape)
    r3 = vc3 = v3 = None
    if _is_factored(v):
        vr3 = v["vr"].view(p3.shape[0], p3.shape[1])
        vc3 = v["vc"].view(p3.shape[0], C)
        r3 = _factored_moments(g3, vr3, vc3, ocfg.b2)
    else:
        v3 = _moment3(v, shape)
    for es in _blocks(*p3.shape):
        v_hat = None if r3 is None else r3[es][..., None] * vc3[es][:, None, :]
        _update_block(p3[es], g3[es], _sub(m3, es),
                      None if v3 is None else _sub(v3, es), v_hat,
                      lr, bc1, bc2, ocfg, wd)


def _layer(m, i: int):
    return {k: t[i] for k, t in m.items()} if isinstance(m, dict) else m[i]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _sumsq(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares as f32.  On the card ``vector_norm`` in f32
    (a tree reduction, no copy of the leaf); on the CPU, whose
    ``vector_norm`` accumulates in order (in f32, 6.5e-4 low at 2**24
    elements), in f64: accurate to f32's rounding, and the same bits at
    any thread count (a crash's resume repeats a run's steps bit for
    bit)."""
    if g.device.type == "cpu":
        return torch.linalg.vector_norm(g, dtype=torch.float64).square().to(
            torch.float32)
    return torch.linalg.vector_norm(g, dtype=torch.float32).square()


def global_norm(grads: Dict[str, torch.Tensor], replicas=None,
                group=None) -> torch.Tensor:
    """sqrt(sum of squares) over the leaves, accumulated in f32 (on the
    card without an f32 copy of any leaf).  No host sync.

    Across ranks ``grads`` are this rank's blocks, ``replicas[path]`` how
    many ranks hold each block of a leaf: each block's squares count once
    (divided by its replicas) in a sum over ``group`` before the root."""
    sq = sum(_sumsq(g) / (1 if replicas is None else replicas[path])
             for path, g in grads.items())
    if group is not None:
        sq = collectives.all_reduce_(torch.as_tensor(sq).clone(), group)
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        replicas=None, group=None):
    """Scale every leaf by min(1, max_norm / norm), in place and in the
    grad's own dtype; returns (grads, norm).  ``replicas`` and ``group``
    are ``global_norm``'s."""
    norm = global_norm(grads, replicas, group)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _flat(tree, path=""):
    """{path: leaf} of a params-like tree; a moment dict ({"q", "s"} or
    {"vr", "vc"}) counts as one leaf."""
    if isinstance(tree, dict) and not (_is_quant(tree) or _is_factored(tree)):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _fused(m, v) -> bool:
    return (isinstance(m, torch.Tensor) and isinstance(v, torch.Tensor)
            and m.dtype == torch.float32 and v.dtype == torch.float32)


def apply_updates(param_schema, params, grads, state, ocfg: OptimizerConfig,
                  *, mesh=None, replicas=None):
    """One AdamW step, in place.  Returns (params, state, stats).

    ``grads`` is a tree like ``params`` (param dtype or f32) and is
    clipped in place.  ``state["count"]`` is replaced by count + 1;
    ``stats`` holds the pre-clip ``grad_norm`` and this step's ``lr``,
    both f32 tensors on the params' device.

    On ``mesh`` (a ``launch.mesh.RankMesh``) params, grads and moments are
    this rank's blocks and ``replicas`` maps each leaf's path to the ranks
    that hold each of its blocks: the norm is the global one
    (``global_norm``), and every leaf updates its block, the f32 ones
    through the fused kernel.  The int8 and factored recipes reduce over
    whole matrices and raise on more than one rank.
    """
    _check_recipe(ocfg)
    group = None
    if mesh is not None:
        if mesh.world_size > 1 and (ocfg.moment_dtype == "int8"
                                    or ocfg.second_moment == "factored"):
            raise NotImplementedError(
                f"moment_dtype={ocfg.moment_dtype!r}, second_moment="
                f"{ocfg.second_moment!r} on {mesh.world_size} ranks: their "
                f"blocks and means span whole matrices (ROADMAP queue A)")
        group = mesh.world
    flat_p, flat_m, flat_v = _flat(params), _flat(state["m"]), _flat(state["v"])
    flat_g = {k: g.contiguous() for k, g in _flat(grads).items()}
    if ocfg.grad_clip:
        flat_g, gnorm = clip_by_global_norm(flat_g, ocfg.grad_clip,
                                            replicas, group)
    else:
        gnorm = global_norm(flat_g, replicas, group)
    count = state["count"] + 1
    lr = learning_rate(ocfg, count)
    t = count.to(torch.float32)
    bc1 = 1.0 - ocfg.b1 ** t
    bc2 = 1.0 - ocfg.b2 ** t
    scalars = torch.stack([lr, bc1, bc2]).to(torch.float32).contiguous()
    for path, spec in leaves(param_schema):
        wd = ocfg.weight_decay if decays(spec) else 0.0
        p, g, m, v = flat_p[path], flat_g[path], flat_m[path], flat_v[path]
        if _fused(m, v):
            adamw_update(p, g, m, v, scalars, b1=ocfg.b1, b2=ocfg.b2,
                         eps=ocfg.eps, weight_decay=wd)
        elif _layered(spec):
            for i in range(spec.shape[0]):
                _update_slice(p[i], g[i], _layer(m, i), _layer(v, i),
                              lr, bc1, bc2, ocfg, wd)
        else:
            _update_slice(p, g, m, v, lr, bc1, bc2, ocfg, wd)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

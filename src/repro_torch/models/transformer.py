"""Decoder-only LM over heterogeneous layer groups.

The schema is the JAX package's (``models/transformer.py``): parameters of
each block kind in ``cfg.block_pattern`` are stacked along a leading group
axis G, and caches are stacked the same way.  The JAX model scans over
groups; here ``forward`` is a Python loop over the group axis.

Each block kind registers (schema, cache schema, apply) in ``KINDS``, as in
the reference: the dense attention kinds ``attn``/``global``/``local``
(gemma2's ``local`` with its sliding window, all with the config's logit
softcap, post-norms and embed scale) live here, the top-k MoE kind
(``moe``: attention, then routed experts through the grouped-matmul
kernel, with the attention cache, so it pages) in ``models.moe``, Mamba2
(``mamba``), zamba2's ``mamba_attn`` and RWKV6 (``rwkv``) in
``models.ssm``, and the VLM's gated cross attention (``cross``) in
``models.vlm``.  ``apply(cfg, p, x, *, mode, positions, cache, pos,
shared, extras) -> (x, new_cache)``; ``shared`` is zamba2's one set of
shared attention weights (``params["shared_attn"]``, no G axis) and
``extras`` the modality stubs (``{"image_embeds": (B, P, vision_dim)}``
for the VLM), which the other kinds take and ignore.  The whisper
encoder-decoder is its own module, ``models.encdec``.

Prefill returns new caches: each kind's cache dict per layer, every leaf
stacked across groups.  Decode writes the step's k/v and recurrent state
into the cache tensors in place (the JAX functions return new caches);
callers that need the old cache clone it.

Train runs every kind, keeps the autograd graph and no caches: the second
item a kind returns in train is ``{}``, or ``{"aux": f32 scalar}`` for the
MoE kind's load-balance loss, which ``loss_fn`` and ``rl_loss_fn`` add to
the loss as the reference does (``nll + aux``).  MoE trains through the
grouped-matmul kernel's gradient, the recurrent kinds through the scan
kernels' forward with the plain chunked form's gradient
(``ssm_scan.ssd_scan_train``, ``wkv6.wkv6_train``).
With ``par.remat`` each layer group runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the scan
body), so backward keeps one group's input per group and recomputes the
rest.  ``loss_fn`` follows the reference's routing: the chunked
cross-entropy (through the fused xent kernel) unless the vocab and
sequence divide 16 and the layout is not pure-FSDP.  Across ranks
(``mesh=``, a ``launch.mesh.RankMesh``) ``loss_fn`` and ``rl_loss_fn``
gather the top-level leaves (zamba2's shared attention among them: once
a microbatch, for every ``mamba_attn`` layer and its recompute), the
train forward ZeRO-gathers each layer group's inside its remat scope,
and the kinds of ``MESH_KINDS`` get the mesh and the ``ParallelConfig``.
Under tensor and sequence parallelism on ``model``
(``layers.sequence_parallel``, the reference's default layout) the stream
between layers is this rank's sequence slice: each block gathers it
(``collectives.sp_gather``), computes this rank's heads and ff columns
(``_tp_blocks`` cuts them from the rank's blocks, gathering over
``model`` a leaf whose split the compute cannot use), and reduce-scatters
its row-parallel output back onto the slice (``collectives.sp_scatter``);
the loss is each rank's rows' mean, averaged over ``model``.  Under pure
FSDP (``par.pure_fsdp``) each rank holds its own rows and every leaf's
blocks split over ``("data", "model")`` (or, where that does not divide,
over ``model`` alone): each leaf is gathered whole from its spec
(``_gathers``), a dimension split over both axes once over the world
group, and the loss is the chunked cross entropy over the rank's rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import losses
from repro_torch.models.layers import (compute_dtype, embed_tokens, rms_norm,
                                       sequence_parallel, swiglu, unembed)
from repro_torch.models.params import PSpec, tree_map_schema
from repro_torch.sharding import collectives, specs

# kind -> {"schema": (cfg, G) -> {name: PSpec},
#          "cache": (cfg, B, S, G) -> {name: PSpec or dict},
#          "apply": (cfg, p, x, *, mode, positions, cache, pos, shared,
#                    extras[, mesh, par]) -> (x, new_cache)}; the kinds of
#          ``MESH_KINDS`` take ``mesh`` and ``par`` (train across ranks)
KINDS: Dict[str, Dict[str, Callable]] = {}


def register_kind(name: str, schema, cache, apply) -> None:
    KINDS[name] = {"schema": schema, "cache": cache, "apply": apply}


def _kind(kind: str) -> Dict[str, Callable]:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} does not exist; the port runs "
            f"{sorted(KINDS)}, as the JAX package does")
    return KINDS[kind]


def _attn_mlp_schema(cfg: ModelConfig, G: int) -> Dict[str, PSpec]:
    D, H, KV, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    heads_div = H % 16 == 0
    hq = "tp_heads" if heads_div else None
    hd = "head_dim" if heads_div else "tp_head_dim"
    s: Dict[str, PSpec] = {
        "ln1": PSpec((G, D), ("layers", None), "zeros"),
        "wq": PSpec((G, D, H, dh), ("layers", "fsdp", hq, hd)),
        "wk": PSpec((G, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd)),
        "wv": PSpec((G, D, KV, dh), ("layers", "fsdp", "tp_kv_heads", hd)),
        "wo": PSpec((G, H, dh, D), ("layers", hq, hd, "fsdp")),
        "ln2": PSpec((G, D), ("layers", None), "zeros"),
        "wg": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wu": PSpec((G, D, F), ("layers", "fsdp", "tp_ff")),
        "wo_mlp": PSpec((G, F, D), ("layers", "tp_ff", "fsdp")),
    }
    if cfg.attn.qkv_bias:
        s["bq"] = PSpec((G, H, dh), ("layers", "tp_heads", "head_dim"), "zeros")
        s["bk"] = PSpec((G, KV, dh), ("layers", "tp_kv_heads", "head_dim"), "zeros")
        s["bv"] = PSpec((G, KV, dh), ("layers", "tp_kv_heads", "head_dim"), "zeros")
    if cfg.post_norm:
        s["ln1_post"] = PSpec((G, D), ("layers", None), "zeros")
        s["ln2_post"] = PSpec((G, D), ("layers", None), "zeros")
    return s


def _attn_cache_schema(cfg: ModelConfig, B: int, S: int, G: int):
    KV, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": PSpec((G, B, S, KV, dh), ax, "zeros"),
            "v": PSpec((G, B, S, KV, dh), ax, "zeros")}


def lm_schema(cfg: ModelConfig) -> Dict[str, Any]:
    G = cfg.num_groups
    schema: Dict[str, Any] = {
        "embed": PSpec((cfg.vocab_size, cfg.d_model), ("tp_vocab", "fsdp"),
                       scale=0.02),
        "blocks": {f"{i}_{kind}": _kind(kind)["schema"](cfg, G)
                   for i, kind in enumerate(cfg.block_pattern)},
        "final_norm": PSpec((cfg.d_model,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = PSpec((cfg.vocab_size, cfg.d_model),
                                  ("tp_vocab", "fsdp"))
    if "mamba_attn" in cfg.block_pattern:   # zamba2 shared attention weights
        from repro_torch.models import ssm
        schema["shared_attn"] = ssm.shared_attn_schema(cfg)
    return schema


def cache_schema(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    G = cfg.num_groups
    return {f"{i}_{kind}": _kind(kind)["cache"](cfg, B, S, G)
            for i, kind in enumerate(cfg.block_pattern)}


def insert_kv(cache, k, v, pos) -> None:
    """Write this step's k/v (B,1,KV,dh) into ``cache`` (B,S,KV,dh) in place.

    ``pos`` is a scalar (every row at one position, clamped to the cache
    like ``dynamic_update_slice``) or a (B,) tensor (each slot at its own
    position).  A vector entry >= the cache length writes nothing.
    """
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    if not torch.is_tensor(pos):
        at = min(max(int(pos), 0), S - 1)
        kc[:, at] = k[:, 0]
        vc[:, at] = v[:, 0]
        return
    if pos.dim() == 0:
        # a tensor index: no read of pos back to the host
        at = pos.clamp(0, S - 1).reshape(1).to(device=kc.device,
                                                dtype=torch.long)
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        return
    rows = torch.arange(kc.shape[0], device=kc.device)
    at = pos.clamp(0, S - 1)
    hit = (pos < S)[:, None, None]
    kc[rows, at] = torch.where(hit, k[:, 0].to(kc.dtype), kc[rows, at])
    vc[rows, at] = torch.where(hit, v[:, 0].to(vc.dtype), vc[rows, at])


def attention_part(cfg: ModelConfig, p, x, *, window, mode, positions,
                   cache, pos, mesh=None, par=None):
    """Pre-norm attention sub-block shared by the dense and hybrid kinds.
    Returns (x, new_cache): prefill's k/v, decode's cache (written in place)
    or {} in train.

    Under sequence parallelism (``layers.sequence_parallel(mesh, par)``)
    ``x`` is this rank's sequence slice and ``p`` holds its heads'
    projections (``_tp_blocks``): the normed slices are gathered, this
    rank's heads attend over the whole sequence (``positions`` covers it),
    and the output projection's partial sums are reduce-scattered back
    onto the slice."""
    sp = sequence_parallel(mesh, par)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if sp:
        h = collectives.sp_gather(h, 1, mesh.groups["model"])
    q, k, v = attn_mod.qkv_proj(cfg, p, h, positions)
    new_cache = {}
    if mode == "decode":
        insert_kv(cache, k, v, pos)
        out = attn_mod.decode_attention(
            q, cache["k"], cache["v"], pos, window=window,
            logit_softcap=cfg.attn.logit_softcap)
        new_cache = cache
    elif mode == "train":
        out = attn_mod.train_attention(
            q, k, v, window=window, logit_softcap=cfg.attn.logit_softcap)
    else:
        out = attn_mod.causal_attention(
            q, k, v, window=window, logit_softcap=cfg.attn.logit_softcap)
        new_cache = {"k": k, "v": v}
    out = attn_mod.attn_out(cfg, p, out)
    if sp:
        out = collectives.sp_scatter(out, 1, mesh.groups["model"])
    if cfg.post_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    return x + out, new_cache


def mlp_part(cfg: ModelConfig, p, x, mesh=None, par=None):
    """Pre-norm SwiGLU sub-block; under sequence parallelism column-parallel
    ``wg``/``wu`` and row-parallel ``wo_mlp`` on this rank's ff columns,
    between the gather and the reduce-scatter of ``attention_part``."""
    sp = sequence_parallel(mesh, par)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if sp:
        h = collectives.sp_gather(h, 1, mesh.groups["model"])
    out = swiglu(cfg, {"wg": p["wg"], "wu": p["wu"], "wo": p["wo_mlp"]}, h)
    if sp:
        out = collectives.sp_scatter(out, 1, mesh.groups["model"])
    if cfg.post_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out


def _make_attn_apply(window_of: Callable[[ModelConfig], Optional[int]]):
    def apply(cfg, p, x, *, mode, positions, cache, pos, shared,
              extras=None, mesh=None, par=None):
        x, new_cache = attention_part(
            cfg, p, x, window=window_of(cfg), mode=mode, positions=positions,
            cache=cache, pos=pos, mesh=mesh, par=par)
        return mlp_part(cfg, p, x, mesh, par), new_cache
    return apply


for _name, _window_of in (("attn", lambda cfg: None),
                          ("global", lambda cfg: None),
                          ("local", lambda cfg: cfg.attn.window)):
    register_kind(_name, schema=_attn_mlp_schema, cache=_attn_cache_schema,
                  apply=_make_attn_apply(_window_of))


def _index(tree, gi: int):
    """Group ``gi`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, gi) for k, v in tree.items()}
    return tree[gi]


def _stack(trees: list):
    """Stack a list of same-shaped cache trees along a new group axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# the kinds a train step runs on a mesh: each layer's leaves ZeRO-gathered,
# the experts split over ``model``, the dense part replicated over it or,
# under tensor parallelism, cut into heads and ff columns (``_tp_blocks``);
# the recurrent kinds (``SCAN_KINDS``) under pure FSDP or on a model axis of
# 1 alone, where each rank scans its own rows and nothing is cut
SCAN_KINDS = ("mamba", "mamba_attn", "rwkv")
MESH_KINDS = ("attn", "global", "local", "moe") + SCAN_KINDS

# under tensor parallelism, the dimension of a layer's leaf (its stacked
# leaf's less the layers axis) of which a rank computes a block, and what
# the block holds: column-parallel q/k/v and gate/up, row-parallel wo and
# wo_mlp
_TP_COMPUTE = {"wq": (1, "heads"), "bq": (0, "heads"), "wo": (0, "heads"),
               "wk": (1, "kv_heads"), "wv": (1, "kv_heads"),
               "bk": (0, "kv_heads"), "bv": (0, "kv_heads"),
               "wg": (1, "ff"), "wu": (1, "ff"), "wo_mlp": (0, "ff")}


def tp_range(cfg: ModelConfig, what: str, tp: int, r: int):
    """[start, stop) of model rank ``r``'s block of ``what`` on a model
    axis of ``tp``: its H / tp query heads (the reference's ``"heads"``
    strategy), the KV heads they read (query head h reads ``h // (H /
    KV)``: KV / tp of them where tp divides KV, else the one KV head the
    reference's repeat of K/V up to H gives this rank's heads), or its
    d_ff / tp columns."""
    if what == "ff":
        n = cfg.d_ff // tp
        return r * n, (r + 1) * n
    H = cfg.num_heads
    h0, h1 = r * H // tp, (r + 1) * H // tp
    if what == "heads":
        return h0, h1
    g = H // cfg.num_kv_heads
    return h0 // g, (h1 - 1) // g + 1


def _tp_blocks(cfg: ModelConfig, gp, model_dims, mesh):
    """A layer group's leaves (ZeRO-gathered over ``data``) -> the blocks
    this rank computes with under tensor parallelism: a leaf of
    ``_TP_COMPUTE`` split over ``model`` along its compute dimension is
    the rank's block as it stands; one split along another dimension
    (wq/wk/wv/wo on head_dim: split-half RoPE pairs dims i and i + dh/2,
    which a contiguous half of head_dim does not hold) is gathered over
    ``model`` (``zero_gather``: its gradient reduce-scattered) and cut; one
    replicated over ``model`` is cut (its gradient, zero outside the cut,
    is summed over ``model`` in ``runtime.steps``).  Every other leaf (the
    norms, the router: replicated; the experts: split) stays whole."""
    group = mesh.groups["model"]
    tp, r = mesh.size("model"), mesh.coords["model"]
    out = {}
    for key, grp in gp.items():
        blk = {}
        for name, leaf in grp.items():
            md = model_dims[key][name]
            if name in _TP_COMPUTE:
                cd, what = _TP_COMPUTE[name]
                a, b = tp_range(cfg, what, tp, r)
                if md != cd:
                    if md is not None:
                        leaf = collectives.zero_gather(leaf, md, group)
                    leaf = leaf.narrow(cd, a, b - a)
            blk[name] = leaf
        out[key] = blk
    return out


def _seq_slice(t: torch.Tensor, mesh) -> torch.Tensor:
    """This ``model`` rank's slice of the sequence (dim 1) of ``t``."""
    tp, r = mesh.size("model"), mesh.coords["model"]
    n = t.shape[1] // tp
    return t[:, r * n:(r + 1) * n]


def _train_forward(cfg: ModelConfig, par: ParallelConfig, params,
                   tokens: torch.Tensor, extras=None, mesh=None):
    """-> (final hidden states, the blocks' aux loss summed in f32).

    ``mesh`` (a ``launch.mesh.RankMesh``): ``params`` holds this rank's
    blocks, whose ``data``-split leaves (under pure FSDP every split leaf,
    ``_zero_axes``) each layer group gathers inside its remat scope
    (``collectives.zero_gather``, ``_gathers``), so the gathered weights
    of one group at a time live beyond the shards; the top-level leaves
    come whole (``loss_fn`` gathers them).  The kinds get the mesh and
    ``par``.  Under sequence parallelism the rank embeds its slice of ``tokens``,
    cuts each group's heads and ff columns inside the same remat scope
    (``_tp_blocks``), and returns its slice's hidden states.
    """
    for kind in cfg.block_pattern:
        _kind(kind)
    sp = sequence_parallel(mesh, par)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if sp:
        tokens = _seq_slice(tokens, mesh)
    x = embed_tokens(cfg, params["embed"], tokens)
    # one unbind per stacked leaf: backward stacks its per-group grads in
    # one op, where indexing each group would add a full-size zero tensor
    # per group
    groups = {key: {name: leaf.unbind(0) for name, leaf in grp.items()}
              for key, grp in params["blocks"].items()}

    shared = params.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kw = {}
    if mesh is not None:
        kw = {"mesh": mesh, "par": par}
        plans = _layer_plans(_gathers(cfg, par, mesh,
                                      _zero_axes(par, mesh)))
        if sp:
            model_dims = _layer_dims(_axis_dims(cfg, par, mesh, "model"))

    def body(x, aux, gp):
        if mesh is not None:
            gp = collectives.zero_gather_tree(gp, plans)
        if sp:
            gp = _tp_blocks(cfg, gp, model_dims, mesh)
        for i, kind in enumerate(cfg.block_pattern):
            x, out = KINDS[kind]["apply"](
                cfg, gp[f"{i}_{kind}"], x, mode="train", positions=positions,
                cache=None, pos=None, shared=shared, extras=extras, **kw)
            if "aux" in out:
                aux = aux + out["aux"]
        return x, aux

    for gi in range(cfg.num_groups):
        gp = {key: {name: sl[gi] for name, sl in grp.items()}
              for key, grp in groups.items()}
        if par.remat:
            x, aux = checkpoint(body, x, aux, gp, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x, aux, gp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _axis_dims(cfg: ModelConfig, par: ParallelConfig, mesh, axis: str):
    """Each leaf's dimension split over mesh axis ``axis`` on ``mesh``, or
    None."""
    rules = specs.logical_rules(par)
    return tree_map_schema(
        lambda _path, p: specs.axis_dim(
            specs.spec_for(p.shape, p.axes, mesh.mesh, rules), axis),
        lm_schema(cfg))


def _layer_dims(dims):
    """The blocks' entries of ``_axis_dims`` on a layer's slice: its
    stacked leaf's dimensions less the layers axis."""
    return {key: {name: None if d is None else d - 1
                  for name, d in grp.items()}
            for key, grp in dims["blocks"].items()}


def _gathers(cfg: ModelConfig, par: ParallelConfig, mesh, axes):
    """Each leaf's gathers over the mesh axes among ``axes``, from its
    spec: a (dim, group) for each dimension split over those axes alone,
    ``group`` the ranks that hold its blocks in order
    (``RankMesh.group_of``: a dimension split over ``("data", "model")``
    is gathered once, over the world group).  Its gradient, the gather's
    reduce-scatter, is summed over the same group."""
    rules = specs.logical_rules(par)

    def plan(_path, p):
        spec = specs.spec_for(p.shape, p.axes, mesh.mesh, rules)
        return [(dim, mesh.group_of(over))
                for dim, over in specs.split_axes(spec).items()
                if set(over) <= set(axes)]
    return tree_map_schema(plan, lm_schema(cfg))


def _zero_axes(par: ParallelConfig, mesh):
    """The mesh axes over which the train forward gathers a leaf whole:
    the ``fsdp`` rule's, ``data`` (ZeRO-3) or under pure FSDP ``("data",
    "model")``; the experts' and, under tensor parallelism, the heads'
    and ff columns' ``model`` splits stay."""
    return specs.rule_axes(specs.logical_rules(par), "fsdp", mesh.mesh)


def _layer_plans(plans):
    """The blocks' entries of ``_gathers`` on a layer's slice."""
    return {key: {name: [(d - 1, g) for d, g in plan]
                  for name, plan in grp.items()}
            for key, grp in plans["blocks"].items()}


def _gather_top(cfg: ModelConfig, par: ParallelConfig, params, mesh):
    """``params`` with its top-level leaves (embedding, head, final norm,
    zamba2's shared attention) gathered whole and its blocks as they are:
    over ``data`` (under pure FSDP over ``("data", "model")``,
    ``_zero_axes``), and under sequence parallelism then over ``model``
    (the vocab of the embedding and head): the lookup and the loss take
    the whole vocab on each rank's rows."""
    top = {k: v for k, v in params.items() if k != "blocks"}
    passes = [_zero_axes(par, mesh)]
    if sequence_parallel(mesh, par):
        passes.append(("model",))
    for axes in passes:
        plans = _gathers(cfg, par, mesh, axes)
        top = collectives.zero_gather_tree(top, {k: plans[k] for k in top})
    return {**top, "blocks": params["blocks"]}


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            mode: str = "prefill", caches=None, pos=None,
            par: Optional[ParallelConfig] = None, extras=None):
    """tokens (B,St) int.  prefill/train: St = S; decode: St = 1.

    Returns (final hidden states (B,St,D), caches).  Prefill returns new
    caches whose sequence axis covers the prompt; decode writes into
    ``caches`` in place and returns them; train returns no caches and
    remats per ``par`` (default ``ParallelConfig()``).  ``extras`` are the
    modality stubs (``runtime.steps.extras_specs``), read by ``cross``
    blocks in prefill and train.
    """
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode {mode!r}: one of prefill, decode, train")
    if mode == "train":
        return _train_forward(cfg, par or ParallelConfig(), params,
                              tokens, extras)[0], None
    kinds = [_kind(kind) for kind in cfg.block_pattern]
    x = embed_tokens(cfg, params["embed"], tokens)
    if mode == "decode":
        p = torch.as_tensor(pos, device=tokens.device)
        positions = p[:, None] if p.dim() == 1 else p.reshape(1)
    else:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    shared = params.get("shared_attn")
    new: Dict[str, list] = {}
    for gi in range(cfg.num_groups):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}_{kind}"
            p = {name: leaf[gi] for name, leaf in params["blocks"][key].items()}
            cache = None if caches is None else _index(caches[key], gi)
            x, nc = kinds[i]["apply"](cfg, p, x, mode=mode,
                                      positions=positions, cache=cache,
                                      pos=pos, shared=shared, extras=extras)
            if mode == "prefill":
                new.setdefault(key, []).append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        caches = {key: _stack(layers) for key, layers in new.items()}
    return x, caches


def lm_head(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits for a few positions (serving), with tied embeddings."""
    return unembed(cfg, lm_head(cfg, params), x, transpose=True)


def loss_fn(cfg: ModelConfig, par: ParallelConfig, params, batch,
            mesh=None):
    """Mean token NLL of ``batch`` ({"tokens", "labels"}: (B,S) int, and
    the VLM's "extras") plus the MoE blocks' aux loss.  On ``mesh`` (a
    ``launch.mesh.RankMesh``) ``params`` and ``batch`` are this rank's:
    the NLL is the mean over its rows (under sequence parallelism over
    the ``model`` group's, ``losses.sequence_parallel_cross_entropy``),
    the aux loss the global one."""
    if mesh is not None:
        params = _gather_top(cfg, par, params, mesh)
    x, aux = _train_forward(cfg, par, params, batch["tokens"],
                            batch.get("extras"), mesh)
    head = lm_head(cfg, params).to(compute_dtype(cfg))
    if sequence_parallel(mesh, par):
        # both of the reference's losses (below) compute mean(lse - gold)
        # over the whole vocab; here each rank's rows go through the xent
        # kernel with the head whole on the rank
        return losses.sequence_parallel_cross_entropy(
            x, _seq_slice(batch["labels"], mesh), head,
            mesh.groups["model"], softcap=cfg.final_logit_softcap) + aux
    S = x.shape[1]
    # the reference's rule: the sharded head needs the vocab on the model
    # axis, which pure-FSDP gives to the batch
    if cfg.vocab_size % 16 == 0 and S % 16 == 0 and not par.pure_fsdp:
        nll = losses.sharded_cross_entropy(
            x, batch["labels"], head, softcap=cfg.final_logit_softcap)
    else:
        nll = losses.chunked_cross_entropy(
            x, batch["labels"], head, softcap=cfg.final_logit_softcap)
    return nll + aux


def _row_ranks(par: ParallelConfig, mesh):
    """(group, size) of the ranks that hold different rows of a batch: the
    ``"batch"`` rule's mesh axes, ``data`` or under pure FSDP ``("data",
    "model")``."""
    axes = specs.rule_axes(specs.logical_rules(par), "batch", mesh.mesh)
    n = 1
    for a in axes:
        n *= mesh.size(a)
    return mesh.group_of(axes), n


def _rl_denominator(mask: torch.Tensor, par: ParallelConfig, mesh
                    ) -> torch.Tensor:
    """The reference's max(sum(mask), 1) over the whole microbatch: the
    mask sums of the ranks that hold its rows, summed (no gradient)."""
    total = mask.detach().sum()
    if mesh is not None:
        collectives.all_reduce_(total, _row_ranks(par, mesh)[0])
    return total.clamp_min(1.0)


def _rl_rank_scale(par: ParallelConfig, mesh) -> int:
    """The factor on a rank's share of the RL loss: its rows summed over
    the whole microbatch's denominator are a part of the reference's loss,
    and the parts of the n ranks that hold different rows sum to it, where
    ``runtime.steps`` averages both the grads and the loss metric over
    those ranks; so each rank's copy is n times its part."""
    return 1 if mesh is None else _row_ranks(par, mesh)[1]


def rl_loss_fn(cfg: ModelConfig, par: ParallelConfig, params, batch,
               mesh=None):
    """Advantage-weighted policy-gradient loss (the RL learner's).

    ``batch`` holds tokens/labels (B,S) int as in ``loss_fn``, mask (B,S)
    f32 (1.0 on generated label positions) and advantages (B,) f32.  The
    surrogate sum_t A * -log pi(label_t) / max(sum(mask), 1) is
    cross entropy weighted by mask * advantage, so it runs through
    ``losses.weighted_cross_entropy`` and its xent kernel; prompt and pad
    positions weigh 0 and get no gradient.  The MoE blocks' aux loss is
    added, as in ``loss_fn``.

    On ``mesh`` (a ``launch.mesh.RankMesh``) ``params`` and ``batch`` are
    this rank's, the top-level leaves are gathered as in ``loss_fn``, the
    denominator is the whole microbatch's (``_rl_denominator``) and the
    rank's share is scaled by ``_rl_rank_scale``; under sequence
    parallelism each rank weighs its sequence slice, and the ``model``
    group's slices are summed (``tp`` times their ``group_mean``).
    """
    if mesh is not None:
        params = _gather_top(cfg, par, params, mesh)
    x, aux = _train_forward(cfg, par, params, batch["tokens"],
                            batch.get("extras"), mesh)
    head = lm_head(cfg, params).to(compute_dtype(cfg))
    mask = batch["mask"].float()
    w = mask * batch["advantages"].float()[:, None]
    labels = batch["labels"]
    sp = sequence_parallel(mesh, par)
    if sp:
        labels, w = _seq_slice(labels, mesh), _seq_slice(w, mesh)
    pg = losses.weighted_cross_entropy(
        x, labels, head, w, denom=_rl_denominator(mask, par, mesh),
        softcap=cfg.final_logit_softcap)
    if sp:
        pg = collectives.group_mean(pg, mesh.groups["model"]) * \
            mesh.size("model")
    return pg * _rl_rank_scale(par, mesh) + aux


# the MoE, recurrent and cross kinds (module imports after the definitions
# above: models.moe and models.ssm reach back for attention_part, mlp_part
# and the attention schemas)
from repro_torch.models import moe as _moe  # noqa: E402
from repro_torch.models import ssm as _ssm  # noqa: E402
from repro_torch.models import vlm as _vlm  # noqa: E402

register_kind("moe", schema=_moe.moe_block_schema, cache=_attn_cache_schema,
              apply=_moe.apply_moe_block)

register_kind("mamba", schema=_ssm.mamba_schema, cache=_ssm.mamba_cache_schema,
              apply=_ssm.apply_mamba)
register_kind("mamba_attn", schema=_ssm.mamba_attn_schema,
              cache=_ssm.mamba_attn_cache_schema, apply=_ssm.apply_mamba_attn)
register_kind("rwkv", schema=_ssm.rwkv_schema, cache=_ssm.rwkv_cache_schema,
              apply=_ssm.apply_rwkv)
register_kind("cross", schema=_vlm.cross_schema, cache=_vlm.cross_cache_schema,
              apply=_vlm.apply_cross)

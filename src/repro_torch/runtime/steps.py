"""Train, serving step functions and the KV cache layouts, in PyTorch.

Mirrors the JAX package's ``runtime/steps.py``, with meshes in training
only (below, laid out by hand where the reference has GSPMD).  Training,
for every family the port serves, through the family's model module
(``_model_module``: its ``lm_schema`` and ``loss_fn``, as the
reference's ``_train_pieces`` picks them), on batches that carry the
family's ``extras`` (whisper's frames, the VLM's image embeddings) whenever
``extras_specs`` gives any:

  * ``init_opt_state`` — zero AdamW state for a config's params;
  * ``train_step`` — one optimizer step on a (B, S) batch, folding
    ``ocfg.accum_steps`` microbatches whose grads are summed in f32 (the
    reference's scan), then ``optim.adamw.apply_updates`` in place;
  * ``train_chunk`` — K steps on a (K, B, S) chunk with the metrics
    stacked on the device, so the host syncs once per chunk;
  * ``rl_train_chunk`` — the same with the RL learner's loss (the model
    module's ``rl_loss_fn``; whisper's ``encdec`` has none, as in the
    reference) and batch (``rl_batch_specs``).

Serving, for every family the port serves (``_model_module``: the
encoder-decoder ``models.encdec`` for "audio", ``models.transformer``
otherwise, which holds the VLM's cross kind), with the modality stubs of
``extras_specs`` passed to prefill:

  * ``prefill_step``  — B=1 prefill; unembeds only the last position;
  * ``slot_decode_step`` — one greedy step over all slots, each at its own
    position, against the slotted cache (layers, slots, S, KV, dh);
  * the paged pool (layers, num_blocks, block_size, KV, dh) addressed by
    per-slot block tables: ``paged_cache_view`` gathers a contiguous view,
    the decode forward runs on it unchanged, ``paged_cache_scatter`` writes
    back the one row each slot wrote.  Block 0 is the null block: table
    entries for unallocated positions point at it and out-of-range writes
    land on it; the decode mask turns its garbage into an exact 0.0
    contribution, which keeps paged decode bit-identical to slotted.

The JAX functions return new params, optimizer state and caches (their
inputs are donated); these update the given params, moments, cache or pool
in place and return them.  Train steps take ``device=`` (default
``"cuda"``, which raises without a card) and move host batches there.

Across ranks (``train_step`` / ``train_chunk`` given ``mesh=``, a
``launch.mesh.RankMesh`` of one process a rank, ``launch.ranks``) the
layout is the reference's rules on a ``("data", "model")`` mesh, in one of
three forms.  Under pure FSDP (``train_par``'s switch: phi4, gemma2,
codeqwen, deepseek, zamba2 and rwkv6 train so wherever the global batch
divides the ranks) the batch and each leaf's ``fsdp`` axis split over
``("data", "model")`` (over ``model`` alone where that does not divide),
every leaf is gathered whole a layer group at a time and nothing else
moves.  The other two split the batch over ``data``, each leaf's
``fsdp`` axis over ``data`` (ZeRO-3: ``collectives.zero_gather`` a layer
group at a time, the gradients reduce-scattered and averaged) and the
MoE leaves' ``expert`` axis over ``model`` (``models.moe``'s exchange).
Under ``ParallelConfig(tensor_parallel=False, sequence_parallel=False)``
everything else is replicated over ``model``.  Under both flags on (the
reference's default) the heads, KV heads, ff columns and vocab split over
``model`` as ``sharding.specs`` lays them out, the stream between layers
is each rank's sequence slice (``models.layers.sequence_parallel``), and
a leaf replicated over ``model`` gets each rank's partial gradient, summed
over ``model`` here (``_reduce_grads``).  ``shard_params`` /
``init_opt_state(mesh=)`` give a rank its blocks
(``sharding.specs.local_shard``), and ``check_layout`` raises
``NotImplementedError`` for what asks for more.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_num_chips
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import sequence_parallel
from repro_torch.optim import adamw
from repro_torch.sharding import collectives, specs


def _model_module(cfg: ModelConfig):
    """The model module of ``cfg``'s family (the same API either way)."""
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec
    return tfm


def resolve_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Bind shape-dependent stub dims (whisper's frame count) into the
    config, as the reference does."""
    if cfg.family == "audio" and cfg.encoder_frames == 0:
        return cfg.replace(encoder_frames=shape.seq_len)
    return cfg


def token_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token-sequence length for train/prefill (enc-dec: decoder length)."""
    return cfg.decoder_len if cfg.family == "audio" else shape.seq_len


def extras_specs(cfg: ModelConfig, B: int):
    """The modality-frontend stubs (precomputed embeddings) as ``meta``
    tensors, or None: the VLM's image embeddings (B, num_patches,
    vision_dim) and whisper's frames (B, encoder_frames, d_model), bf16
    as in the reference."""
    def meta(shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    if cfg.family == "vlm":
        return {"image_embeds": meta((B, cfg.num_patches, cfg.vision_dim))}
    if cfg.family == "audio":
        return {"frames": meta((B, cfg.encoder_frames, cfg.d_model))}
    return None


# the logical axes of each stub, as the reference's ``extras_specs`` gives
EXTRAS_AXES = {"image_embeds": ("batch", None, None),
               "frames": ("batch", "seq", None)}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(``meta`` tensors, logical axes) of one global training batch: int32
    "tokens" and "labels" (B, ``token_len``) and the family's "extras"
    where ``extras_specs`` gives any, as the reference's ``batch_specs``
    (``cfg`` resolved by ``resolve_cfg``)."""
    B, S = shape.global_batch, token_len(cfg, shape)
    tokens = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    axes = {k: ("batch", "seq") for k in tokens}
    extras = extras_specs(cfg, B)
    if extras is not None:
        tokens["extras"] = extras
        axes["extras"] = {k: EXTRAS_AXES[k] for k in extras}
    return tokens, axes


def zero_extras(cfg: ModelConfig, B: int, device):
    """``extras_specs`` as bf16 zeros on ``device`` (or None): the stubs
    the serving engines and the static batcher feed to prefill."""
    specs = extras_specs(cfg, B)
    return None if specs is None else {
        k: torch.zeros(v.shape, dtype=v.dtype, device=device)
        for k, v in specs.items()}


def prefill_step(cfg: ModelConfig, params, tokens: torch.Tensor,
                 extras=None):
    """tokens (B,S) -> (last-position logits (B,V), prompt-length caches).
    ``extras`` holds the family's stubs (``extras_specs``), if it has any."""
    mod = _model_module(cfg)
    hidden, caches = mod.forward(cfg, params, tokens, mode="prefill",
                                 extras=extras)
    last = mod.lm_logits(cfg, params, hidden[:, -1:, :])[:, 0, :]
    return last, caches


def _greedy_decode(cfg: ModelConfig, params, caches, token, pos):
    mod = _model_module(cfg)
    hidden, caches = mod.forward(cfg, params, token, mode="decode",
                                 caches=caches, pos=pos)
    logits = mod.lm_logits(cfg, params, hidden)
    return logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None], caches


def slot_decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor,
                     pos: torch.Tensor):
    """One fused greedy step: token (B,1), pos (B,) (or one scalar for
    every row) -> (next (B,1), caches)."""
    return _greedy_decode(cfg, params, caches, token, pos)


# ---------------------------------------------------------------------------
# slotted cache: allocation + slot insert/evict (slot = index of axis 1)
# ---------------------------------------------------------------------------

def _zeros(schema, dtype: str, device):
    return pr.tree_map_schema(
        lambda _path, p: torch.zeros(p.shape, dtype=pr.torch_dtype(p.dtype or dtype),
                                     device=device), schema)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_cache(cfg: ModelConfig, B: int, S: int, device):
    """An all-zeros decode cache for B slots of S positions."""
    return _zeros(_model_module(cfg).cache_schema(cfg, B, S),
                  cfg.param_dtype, device)


def cache_batch_insert(dst, src, slot: int):
    """Copy a 1-slot cache ``src`` (sequence axis may be shorter) into slot
    ``slot`` of ``dst``; the tail stays as is, hidden by the decode mask."""
    def ins(d, s):
        d[:, slot:slot + 1, :s.shape[2]] = s.to(d.dtype)
        return d
    return _map(ins, dst, src)


def cache_prefix_insert(dst, src):
    """Copy a cache whose sequence axis covers only the prompt into the
    front of a full-length one of the same batch (a state leaf without a
    sequence axis is replaced whole)."""
    def ins(d, s):
        d[tuple(slice(0, n) for n in s.shape)] = s.to(d.dtype)
        return d
    return _map(ins, dst, src)


def cache_batch_evict(dst, slot: int):
    """Zero one slot (hygiene; correctness never needs it)."""
    def ev(d):
        d[:, slot] = 0
        return d
    return _map(ev, dst)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def paged_compatible(cfg: ModelConfig, S: int, block_size: int) -> bool:
    """True iff every cache leaf of the family's cache schema is a
    (layers, batch, cache_seq, ...) KV layout whose sequence axis is S and
    divisible into blocks.  State caches, whisper's self cache (its axis 2
    unnamed) and the VLM's cross K/V (P rows, not S) are not."""
    if block_size < 1 or S % block_size:
        return False
    flags = []
    pr.tree_map_schema(
        lambda _path, ps: flags.append(
            len(ps.axes) >= 3 and ps.axes[2] == "cache_seq"
            and ps.shape[2] == S),
        _model_module(cfg).cache_schema(cfg, 1, S))
    return bool(flags) and all(flags)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device):
    """An all-zeros pool: leaves (layers, num_blocks, block_size, KV, dh)."""
    return _zeros(_model_module(cfg).cache_schema(cfg, num_blocks,
                                                  block_size),
                  cfg.param_dtype, device)


def paged_cache_view(pool, tables: torch.Tensor):
    """Gather each slot's blocks into a contiguous (layers, B, S, ...) view,
    value-identical to the slotted cache.  ``tables`` is (B, S // bs)."""
    def gather(leaf):
        g = leaf[:, tables]                       # (G, B, nb, bs, *tail)
        return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                         *g.shape[4:])
    return _map(gather, pool)


def paged_cache_scatter(pool, views, tables: torch.Tensor, pos: torch.Tensor):
    """Write back the one row per slot that the decode step wrote (slot i
    at ``pos[i]``).  Rows whose position is out of range land on the null
    block, where duplicate writes are harmless."""
    B = tables.shape[0]
    rows = torch.arange(B, device=tables.device)

    def scat(pleaf, vleaf):
        bs = pleaf.shape[2]
        S = vleaf.shape[2]
        at = pos.clamp(0, S - 1)
        vals = vleaf[:, rows, at]                 # (G, B, *tail)
        blk = tables[rows, (at // bs)]
        blk = torch.where(pos < S, blk, torch.zeros_like(blk))
        pleaf[:, blk, pos % bs] = vals.to(pleaf.dtype)
        return pleaf
    return _map(scat, pool, views)


def paged_prompt_insert(pool, src, blocks: torch.Tensor):
    """Splice a B=1 prefill cache (leaves (layers, 1, P, ...)) into the pool
    at the given (P // block_size,) distinct block ids."""
    def ins(pleaf, sleaf):
        bs = pleaf.shape[2]
        nb = sleaf.shape[2] // bs
        chunks = sleaf[:, 0].reshape(sleaf.shape[0], nb, bs, *sleaf.shape[3:])
        pleaf[:, blocks] = chunks.to(pleaf.dtype)
        return pleaf
    return _map(ins, pool, src)


def paged_decode_step(cfg: ModelConfig, params, pool, tables: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor):
    """One fused per-slot step against the pool: gather views -> the same
    decode forward -> scatter the written rows.  -> (next (B,1), pool)."""
    views = paged_cache_view(pool, tables)
    next_tok, views = _greedy_decode(cfg, params, views, token, pos)
    return next_tok, paged_cache_scatter(pool, views, tables, pos)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def train_par(par: ParallelConfig, *, global_batch: int = 1,
              chips: int = 1) -> ParallelConfig:
    """The reference's pure-FSDP switch for train steps: on when asked for
    and the global batch divides the mesh's chips, which one device always
    does (the dry run passes a production mesh's)."""
    if par.pure_fsdp_train and not par.pure_fsdp \
            and global_batch % chips == 0:
        return dataclasses.replace(par, pure_fsdp=True)
    return par


def init_opt_state(cfg: ModelConfig, ocfg: OptimizerConfig, device="cuda",
                   *, mesh=None, par: ParallelConfig = ParallelConfig()):
    """All-zeros AdamW state {"m", "v", "count"} for ``cfg``'s params; on
    ``mesh`` (a ``launch.mesh.RankMesh``) this rank's blocks of it, as
    ``par``'s rules lay them out."""
    schema = adamw.opt_state_schema(_model_module(cfg).lm_schema(cfg), ocfg)
    if mesh is not None:
        schema = specs.local_schema(schema, mesh.mesh,
                                    specs.logical_rules(par))
    return _zeros(schema, "float32", resolve_device(device))


def check_layout(cfg: ModelConfig, par: ParallelConfig,
                 ocfg: OptimizerConfig, mesh, seq: Optional[int] = None
                 ) -> None:
    """Raise ``NotImplementedError`` naming the missing rule where a train
    step on ``mesh`` (a ``launch.mesh.Mesh``) over sequences of ``seq``
    tokens (None: not checked) would need a layout the port does not run.

    On a ``model`` axis larger than 1 the port runs pure FSDP (the batch
    and every leaf over ``("data", "model")``) for the dense and the
    recurrent kinds (``mamba``, ``mamba_attn``, ``rwkv``: zamba2's and
    rwkv6's own layout wherever the global batch divides the ranks), and
    the experts split over ``model`` with either both of tensor and
    sequence parallelism off or both on (the reference's default).  It
    refuses MoE blocks under pure FSDP, the recurrent kinds outside it
    (the reference's ``tp_inner`` rules), one of tensor and sequence
    parallelism without the other, experts not split over ``model``, and
    under tensor parallelism the reference's ``"seq"`` attention strategy
    (heads that do not split over ``model``), a sequence that does not,
    KV heads whose blocks do not line up with the query heads', and d_ff
    that does not split.  On more than one rank it refuses the int8 and
    factored moments, whisper and the VLM's ``cross`` kind, and a ``pod``
    axis.  Nothing falls back."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise NotImplementedError(
            f"a train step across ranks runs on a ('data', 'model') mesh, "
            f"not {mesh.axis_names}")
    tp = mesh.shape["model"]
    if tp > 1 and par.pure_fsdp:
        if cfg.moe is not None:
            raise NotImplementedError(
                f"ParallelConfig(pure_fsdp=True) with MoE blocks on a model "
                f"axis of {tp}: the reference splits the experts over "
                f"'model' inside its shard_map and reshards the pure-FSDP "
                f"batch into it, which is not ported (ROADMAP queue A)")
    elif tp > 1:
        scan = sorted(set(cfg.block_pattern) & set(tfm.SCAN_KINDS))
        if scan:
            raise NotImplementedError(
                f"{cfg.name}: the recurrent kinds {scan} train across ranks "
                f"under pure FSDP or on a model axis of 1, not under "
                f"ParallelConfig(tensor_parallel={par.tensor_parallel}, "
                f"sequence_parallel={par.sequence_parallel}) on one of {tp} "
                f"(pure_fsdp_train falls to it where the global batch does "
                f"not divide the ranks): the reference splits their inner "
                f"width by its tp_inner rules (src/repro/models/ssm.py:1-4, "
                f"src/repro/sharding/specs.py:60-61), which are not ported "
                f"(ROADMAP R11)")
        if par.tensor_parallel != par.sequence_parallel:
            on, off = (("tensor_parallel", "sequence_parallel")
                       if par.tensor_parallel else
                       ("sequence_parallel", "tensor_parallel"))
            raise NotImplementedError(
                f"ParallelConfig({on}=True, {off}=False) on a model axis "
                f"of {tp}: the port runs tensor and sequence parallelism "
                f"together (the tp_* rules with act_seq_sharded on "
                f"'model') or neither; one without the other is not "
                f"ported (ROADMAP queue A)")
        if par.tensor_parallel:
            _check_tp(cfg, tp, seq)
        if cfg.moe is not None and not par.expert_parallel:
            raise NotImplementedError(
                f"experts replicated over a model axis of {tp} "
                f"(expert_parallel=False) are not ported")
        if cfg.moe is not None and cfg.moe.num_experts % tp:
            raise NotImplementedError(
                f"{cfg.moe.num_experts} experts do not split over a model "
                f"axis of {tp}")
    if mesh_num_chips(mesh) > 1 and (
            ocfg.moment_dtype == "int8" or ocfg.second_moment == "factored"):
        raise NotImplementedError(
            f"moment_dtype={ocfg.moment_dtype!r}, second_moment="
            f"{ocfg.second_moment!r} on more than one rank: the int8 and "
            f"factored recipes reduce over whole matrices, which ZeRO "
            f"splits (ROADMAP queue A)")
    kinds = set(cfg.block_pattern) - set(tfm.MESH_KINDS)
    if cfg.family == "audio" or kinds:
        raise NotImplementedError(
            f"{cfg.name}: a train step across ranks runs the dense and MoE "
            f"kinds and the recurrent ones {tfm.MESH_KINDS}, not "
            f"{sorted(kinds) or cfg.family!r} (ROADMAP R12)")


def _check_tp(cfg: ModelConfig, tp: int, seq: Optional[int]) -> None:
    """``check_layout``'s rules for tensor and sequence parallelism on a
    ``model`` axis of ``tp``."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if seq is not None and seq % tp:
        raise NotImplementedError(
            f"a sequence of {seq} does not split over a model axis of {tp}: "
            f"sequence parallelism (act_seq_sharded on 'model') needs it to")
    if H % tp:
        raise NotImplementedError(
            f"{H} heads on a model axis of {tp}: the reference's 'seq' "
            f"attention strategy (queries sequence-sharded, K/V gathered; "
            f"attention.py attn_strategy) is not ported, only 'heads'")
    if KV % tp and tp % KV:
        raise NotImplementedError(
            f"{KV} KV heads on a model axis of {tp}: a rank's {H // tp} "
            f"query heads read KV heads that neither split over it nor "
            f"repeat onto it")
    if any(k in ("attn", "global", "local") for k in cfg.block_pattern) \
            and cfg.d_ff % tp:
        raise NotImplementedError(
            f"d_ff {cfg.d_ff} does not split over a model axis of {tp} "
            f"(tp_ff)")


def shard_params(cfg: ModelConfig, par: ParallelConfig, params, mesh):
    """This rank's blocks (contiguous copies) of whole ``params``, as
    ``par``'s rules lay them out on ``mesh`` (a ``launch.mesh.RankMesh``)."""
    spec_tree = specs.leaf_specs(_model_module(cfg).lm_schema(cfg),
                                 mesh.mesh, specs.logical_rules(par))
    return _map(lambda t, spec: specs.local_shard(t, spec, mesh.mesh,
                                                  mesh.coords),
                params, spec_tree)


def _batch_axes(par: ParallelConfig, mesh):
    """The mesh axes a train step splits the batch over, the reference's
    ``"batch"`` rule: ``data``, or under pure FSDP ``("data", "model")``."""
    return specs.rule_axes(specs.logical_rules(par), "batch", mesh.mesh)


def _rank_rows(batch, mesh, accum: int, par: ParallelConfig):
    """This rank's rows of a global batch: of each of the ``accum``
    microbatches (rows i*mb .. (i+1)*mb, as the reference reshapes its
    batch into (accum, B / accum)), the reference's split over the batch
    axes (``_batch_axes``: block k = the rank's index along them, major to
    minor, rows i*mb + k*r .. i*mb + (k+1)*r, r = mb / n), so its
    microbatches hold the tokens the reference's do."""
    B = batch["tokens"].shape[0]
    axes = _batch_axes(par, mesh)
    n, k = 1, 0
    for a in axes:
        n, k = n * mesh.size(a), k * mesh.size(a) + mesh.coords[a]
    if B % (accum * n):
        raise ValueError(f"the batch {B} does not split into {accum} "
                         f"microbatches over the {n} ranks of {axes}")
    mb, r = B // accum, B // (accum * n)
    rows = torch.tensor([i * mb + k * r + j for i in range(accum)
                         for j in range(r)],
                        device=batch["tokens"].device)
    return _map(lambda v: v.index_select(0, rows.to(v.device)), batch)


def _reduce_grads(cfg: ModelConfig, par: ParallelConfig, grads, mesh):
    """Mean over ``data`` of each rank's grads, in place: a leaf split over
    ``data`` was summed by its gather's reduce-scatter, every other one is
    summed here.

    Under sequence parallelism and under pure FSDP every collective's
    backward is its exact transpose, so a rank's grads are those of the
    sum of every rank's copy of the loss, tp times each data group's: a
    leaf split over ``model`` (or gathered over it) has its sum already,
    one replicated over ``model`` holds only this rank's part (its
    sequence slice's, its heads' or ff columns', under pure FSDP its
    rows') and is summed over ``model`` here, and every leaf is divided
    by dp * tp.  Under pure FSDP a leaf split over ``("data", "model")``
    was summed over every rank by its gather over the world group, one
    split over ``model`` alone (``specs.spec_for``'s fallback) is summed
    over ``data`` here, and a replicated one over both: the norms, and
    the recurrent kinds' leaves whose ``tp_inner``, ``tp_inner_heads`` and
    ``conv_k`` axes pure FSDP maps to no mesh axis (mamba's ``conv_w``,
    ``A_log``, ``dt_bias``, ``D_skip``, ``ln_y``; rwkv's ``mu_*``, ``w0``,
    ``u``, ``ln_x`` and lora ``wB``)."""
    dp = mesh.size("data")
    tp = mesh.size("model") if (sequence_parallel(mesh, par)
                                or par.pure_fsdp) else 1
    spec_tree = specs.leaf_specs(_model_module(cfg).lm_schema(cfg),
                                 mesh.mesh, specs.logical_rules(par))

    def mean(g, spec):
        data = dp > 1 and specs.axis_dim(spec, "data") is None
        model = tp > 1 and specs.axis_dim(spec, "model") is None
        if data and model:
            collectives.all_reduce_(g, mesh.world)
        elif data or model:
            collectives.all_reduce_(
                g, mesh.groups["data" if data else "model"])
        return g.div_(dp * tp)
    return _map(mean, grads, spec_tree)


def _loss_metric(value: torch.Tensor, mesh, par: ParallelConfig
                 ) -> torch.Tensor:
    """The global loss on every rank: the mean of the ranks' losses over
    the batch axes (``_batch_axes``), each over an equal share of the rows
    (under sequence parallelism the loss is the model group's mean
    already)."""
    group, n = tfm._row_ranks(par, mesh)
    return collectives.all_reduce_(value.to(torch.float32).clone(),
                                   group) / n


def _loss_of(cfg: ModelConfig, attr: str):
    """The family's loss function ``attr`` (``loss_fn`` or ``rl_loss_fn``),
    raising as the reference does where its module has none."""
    loss = getattr(_model_module(cfg), attr, None)
    if loss is None:
        raise ValueError(
            f"model family {cfg.family!r} does not define {attr!r}")
    return loss


def _value_and_grad(cfg: ModelConfig, par: ParallelConfig, params, batch,
                    loss=None, mesh=None):
    """(loss, grads like params) for one (micro)batch; ``loss`` defaults
    to the family's ``loss_fn``, which takes ``mesh`` where there is one."""
    loss = loss or _loss_of(cfg, "loss_fn")
    kw = {} if mesh is None else {"mesh": mesh}
    req = _map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        value = loss(cfg, par, req, batch, **kw)
        grads = iter(torch.autograd.grad(value, tree_leaves(req)))
    return value.detach(), _map(lambda _t: next(grads), req)


TRAIN_KEYS = ("tokens", "labels")


def rl_batch_specs(B: int, S: int):
    """One batch of rollout trajectories as ``meta`` tensors: the LM batch
    plus a per-token action mask and a per-trajectory advantage (the JAX
    ``rl_batch_specs``).  Its keys are what ``rl_train_chunk`` moves."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"tokens": meta((B, S), torch.int32),
            "labels": meta((B, S), torch.int32),
            "mask": meta((B, S), torch.float32),
            "advantages": meta((B,), torch.float32)}


RL_KEYS = tuple(rl_batch_specs(1, 1))


def _batch_on(cfg: ModelConfig, batch, dev: torch.device, keys=TRAIN_KEYS):
    """``batch``'s ``keys`` on ``dev``, and its nested "extras" dict where
    the family has stubs (``extras_specs``), which must then be there."""
    want = extras_specs(cfg, 1)
    if want is not None:
        if not (isinstance(batch.get("extras"), dict)
                and set(want) <= set(batch["extras"])):
            raise ValueError(
                f"the {cfg.family!r} family ({cfg.name}) trains on "
                f"batch['extras'] with {sorted(want)} (steps.extras_specs)")
        keys = tuple(keys) + ("extras",)
    return {k: _map(lambda t: torch.as_tensor(t).to(dev), batch[k])
            for k in keys}


def train_step(cfg: ModelConfig, par: ParallelConfig, ocfg: OptimizerConfig,
               params, opt_state, batch, *, device="cuda", loss=None,
               keys=TRAIN_KEYS, mesh=None):
    """One optimizer step -> (params, opt_state, metrics), params and
    moments updated in place.

    ``batch`` holds (B, S) int "tokens" and "labels" (numpy or tensors),
    the family's "extras" ({name: (B, ...)}, ``extras_specs``) where it
    has any, and whatever else ``loss`` (default: the family's
    ``loss_fn``) reads, named in ``keys`` (the RL step:
    ``rl_train_chunk``).  The step always consumes the whole batch:
    ``ocfg.accum_steps`` microbatches of B / accum rows each, their losses
    and grads summed in f32 and divided by accum, so the trajectory does
    not depend on accum.  ``metrics`` holds f32 device tensors "loss",
    "grad_norm" and "lr".

    ``mesh`` (a ``launch.mesh.RankMesh``): ``params`` and ``opt_state``
    are this rank's blocks (``shard_params``, ``init_opt_state(mesh=)``)
    and ``batch`` the global one, of which the rank takes its rows
    (``_rank_rows``: over ``data``, under pure FSDP over ``("data",
    "model")``); the grads are averaged over the ranks that hold different
    rows and the update clips by the global norm, so ``metrics`` are the
    reference's global ones on every rank.  ``check_layout`` says what it
    refuses.
    """
    dev = resolve_device(device)
    batch = _batch_on(cfg, batch, dev, keys)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, the step "
                         f"on {dev}")
    B = batch["tokens"].shape[0]
    accum = max(ocfg.accum_steps, 1)
    if B % accum:
        raise ValueError(f"accum_steps={accum} must divide the batch {B}")
    if mesh is None:
        par = train_par(par)
    else:
        par = train_par(par, global_batch=B, chips=mesh.world_size)
        check_layout(cfg, par, ocfg, mesh.mesh,
                     seq=batch["tokens"].shape[1])
        batch = _rank_rows(batch, mesh, accum, par)
        B = batch["tokens"].shape[0]
    if accum == 1:
        value, grads = _value_and_grad(cfg, par, params, batch, loss, mesh)
    else:
        mb = B // accum
        value = torch.zeros((), dtype=torch.float32, device=dev)
        grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=dev), params)
        for i in range(accum):
            micro = _map(lambda v: v[i * mb:(i + 1) * mb], batch)
            l, g = _value_and_grad(cfg, par, params, micro, loss, mesh)
            value = value + l
            _map(lambda acc, new: acc.add_(new), grads, g)
        value = value / accum
        _map(lambda acc: acc.div_(accum), grads)
    schema = _model_module(cfg).lm_schema(cfg)
    replicas = None
    if mesh is not None:
        grads = _reduce_grads(cfg, par, grads, mesh)
        value = _loss_metric(value, mesh, par)
        rules = specs.logical_rules(par)
        replicas = {path: specs.replicas(
            specs.spec_for(p.shape, p.axes, mesh.mesh, rules), mesh.mesh)
            for path, p in pr.leaves(schema)}
    params, opt_state, stats = adamw.apply_updates(
        schema, params, grads, opt_state, ocfg, mesh=mesh,
        replicas=replicas)
    return params, opt_state, {"loss": value.to(torch.float32), **stats}


def train_chunk(cfg: ModelConfig, par: ParallelConfig, ocfg: OptimizerConfig,
                params, opt_state, batches, *, device="cuda", loss=None,
                keys=TRAIN_KEYS, mesh=None):
    """K = ``batches["tokens"].shape[0]`` optimizer steps on a (K, B, S)
    chunk (extras stacked (K, B, ...) alike) -> (params, opt_state,
    metrics stacked (K,) on the device).

    The chunk moves to the device in one copy per leaf, and nothing here
    reads a device value back: the caller syncs once per chunk.  Each step
    is ``train_step`` (with ``loss`` over the batch's ``keys``), so the
    trajectory equals K per-step calls (``mesh``: ``train_step``'s).
    """
    dev = resolve_device(device)
    batches = _batch_on(cfg, batches, dev, keys)
    ms = []
    for j in range(batches["tokens"].shape[0]):
        params, opt_state, m = train_step(
            cfg, par, ocfg, params, opt_state,
            _map(lambda v: v[j], batches), device=dev, loss=loss,
            keys=keys, mesh=mesh)
        ms.append(m)
    return params, opt_state, {k: torch.stack([m[k] for m in ms])
                               for k in ms[0]}


def rl_train_chunk(cfg: ModelConfig, par: ParallelConfig,
                   ocfg: OptimizerConfig, params, opt_state, batches, *,
                   device="cuda", mesh=None):
    """The RL learner's chunk: ``train_chunk`` with the advantage-weighted
    policy-gradient loss (the family's ``rl_loss_fn``) over batches of
    ``rl_batch_specs``' keys (and the family's extras), stacked (K, ...);
    ``mesh`` as in ``train_step`` (the loss's denominator the whole
    microbatch's mask sum, ``models.transformer._rl_denominator``)."""
    return train_chunk(cfg, par, ocfg, params, opt_state, batches,
                       device=device, loss=_loss_of(cfg, "rl_loss_fn"),
                       keys=RL_KEYS, mesh=mesh)

"""Config system: model / parallelism / training recipe dataclasses.

A copy of the JAX package's ``configs/base.py`` (pure dataclasses), so the
port imports nothing of that package.  Every architecture the port runs is
a ``ModelConfig`` in ``repro_torch.configs.<id>``;
``repro_torch.configs.registry`` maps ``--arch <id>`` to it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    """Self-attention variant knobs."""
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (gemma2 local)
    logit_softcap: Optional[float] = None  # attn-score softcap (gemma2: 50.0)
    qkv_bias: bool = False                 # qwen-family bias on q/k/v
    use_rope: bool = True                  # whisper uses learned/sinusoidal


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # tokens are routed with an all_to_all over this logical axis
    expert_axis: str = "expert"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (zamba2) / linear-recurrence knobs."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256          # chunked-scan block length
    conv_kernel: int = 4


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | hybrid | audio | ssm | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: int = 0         # 0 -> d_model // num_heads
    # One scanned "layer group" applies this pattern of block kinds in order.
    # num_layers must equal len(block_pattern) * num_groups.
    # kinds: attn | local | global | moe | mamba | mamba_attn | rwkv | cross
    block_pattern: Tuple[str, ...] = ("attn",)
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    norm_eps: float = 1e-6
    post_norm: bool = False                 # gemma2 sandwich norms
    embed_scale: bool = False               # gemma2 sqrt(d_model) embed scaling
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    # --- audio (whisper): encoder-decoder ---
    encoder_layers: int = 0
    decoder_len: int = 448                  # whisper text positions
    encoder_frames: int = 0                 # 0 -> use shape.seq_len at build time
    # --- vlm: stubbed modality frontend ---
    vision_dim: int = 0                     # patch-embedding dim (stub input)
    num_patches: int = 0
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name, self.num_layers, self.block_pattern)
        return self.num_layers // len(self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """How a step function is laid out on the mesh.

    Mesh axes are ("pod",) "data", "model".  Logical->mesh rules live in
    the JAX package's sharding specs; these knobs gate which rules are active.
    """
    fsdp: bool = True                 # ZeRO-3 weight sharding on "data"
    tensor_parallel: bool = True      # heads/ffn/vocab on "model"
    # pure-FSDP layout (beyond-paper §Perf): batch shards over data AND
    # model axes (1 seq/chip at B=256 on one pod), weights ZeRO-3 over both
    # — no TP, so NO activation gathers; only weight AG + grad RS traffic.
    # Wins for <=10B dense models where tokens/chip * D >= layer weights.
    # Measured (codeqwen train_4k): collectives 150 -> 11.3 GB/chip
    # (bf16-adj), temp 11.6 -> 7.2 GiB.
    pure_fsdp: bool = False
    # apply pure_fsdp to TRAIN steps when global_batch % mesh size == 0
    # (decode/prefill keep the hybrid layout: their batch can't cover
    # the full mesh and the KV cache wants the model axis)
    pure_fsdp_train: bool = False
    expert_parallel: bool = True      # MoE experts on "model"
    sequence_parallel: bool = True    # residual/checkpoint seq on "model"
    context_parallel_decode: bool = True   # KV cache seq on "model" + partial softmax
    remat: bool = True
    remat_period: int = 1             # checkpoint every N layer-groups
    # save the TP-gathered activations instead of re-gathering them in the
    # backward pass (trades (B,S,D)/layer HBM for 4 AGs/layer of traffic)
    remat_save_gathered: bool = False
    scan_layers: bool = True
    hierarchical_allreduce: bool = True    # in-pod RS -> cross-pod AR -> in-pod AG
    grad_compression: Optional[str] = None  # None | "int8"
    moe_microbatch: int = 1           # split tokens in MoE layer to bound a2a buffers


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # memory recipe (1T-scale models need sub-fp32 state; see DESIGN.md)
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8
    second_moment: str = "full"       # full | factored  (factored = adafactor-style)
    accum_steps: int = 1


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seq_len: int = 128
    global_batch: int = 4
    steps: int = 10
    seed: int = 0
    log_every: int = 1
    checkpoint_every: int = 0         # 0 = off
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    def __str__(self) -> str:
        return f"{self.name}(S={self.seq_len},B={self.global_batch},{self.kind})"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs allowed to lower long_500k (sub-quadratic sequence mixing).  All other
# archs are pure full-attention: skipped per spec, noted in DESIGN.md §4.
LONG_CONTEXT_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (1 fwd/train step)."""
    kw: dict[str, Any] = dict(
        num_layers=len(cfg.block_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, chunk=8)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["decoder_len"] = 16
    if cfg.vision_dim:
        kw["vision_dim"] = 32
        kw["num_patches"] = 8
    return cfg.replace(**kw)

"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
(paper-table config) [arXiv:2501.kimi2; unverified].

1T of parameters forces the memory recipe: an int8 blockwise first moment
and a factored second moment (``optim.adamw``).  ``PARALLEL``'s two knobs
are copied as values: neither is read on one device.
"""
from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, ParallelConfig)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163_840, head_dim=112,
    block_pattern=("moe",),
    attn=AttnConfig(rope_theta=50_000.0),
    moe=MoEConfig(num_experts=384, top_k=8, capacity_factor=1.25),
    tie_embeddings=True,
)

OPTIMIZER = OptimizerConfig(moment_dtype="int8", second_moment="factored")
PARALLEL = ParallelConfig(remat_period=1, moe_microbatch=4)

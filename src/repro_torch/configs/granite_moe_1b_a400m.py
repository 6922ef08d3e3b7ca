"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49_155, head_dim=64,
    block_pattern=("moe",),
    attn=AttnConfig(rope_theta=10_000.0),
    moe=MoEConfig(num_experts=32, top_k=8),
    tie_embeddings=True,
)

"""rwkv6-1.6b (Finch) [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892; unverified]."""
from repro_torch.configs.base import (AttnConfig, ModelConfig, ParallelConfig,
                                      RWKVConfig)

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65_536, head_dim=64,
    block_pattern=("rwkv",),
    attn=AttnConfig(use_rope=False),
    rwkv=RWKVConfig(head_dim=64, chunk=64),
    tie_embeddings=True,
)

# The reference's pure-FSDP training layout (the recurrent blocks cannot
# shard the sequence).  The port trains this family; runtime.steps.train_par
# turns the layout on for its train steps.
PARALLEL = ParallelConfig(pure_fsdp_train=True)

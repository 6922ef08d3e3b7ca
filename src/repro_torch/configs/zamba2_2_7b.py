"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].  Shared-attn weights are stored once (not scanned);
every 6th layer applies mamba + the shared attention block."""
from repro_torch.configs.base import (AttnConfig, ModelConfig, ParallelConfig,
                                      SSMConfig)

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10_240, vocab_size=32_000, head_dim=80,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba_attn"),
    attn=AttnConfig(rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
)

# The reference's pure-FSDP training layout (the recurrent blocks cannot
# shard the sequence).  The port trains this family; runtime.steps.train_par
# turns the layout on for its train steps, on one device and across ranks.
PARALLEL = ParallelConfig(pure_fsdp_train=True)

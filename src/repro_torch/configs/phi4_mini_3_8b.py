"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200_064, head_dim=128,
    block_pattern=("attn",),
    attn=AttnConfig(rope_theta=10_000.0),
    tie_embeddings=True,
)

# Training takes the pure-FSDP layout; on one device that routes the loss
# through the chunked cross-entropy (``runtime.steps.train_par``).
PARALLEL = ParallelConfig(pure_fsdp_train=True)

"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11_008, vocab_size=102_400, head_dim=128,
    block_pattern=("attn",),
    attn=AttnConfig(rope_theta=10_000.0),
    tie_embeddings=False,
)

# Training takes the pure-FSDP layout; on one device that routes the loss
# through the chunked cross-entropy (``runtime.steps.train_par``).
PARALLEL = ParallelConfig(pure_fsdp_train=True)

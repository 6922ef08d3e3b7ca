"""gemma2-9b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    d_ff=14_336, vocab_size=256_000, head_dim=256,
    block_pattern=("local", "global"),
    attn=AttnConfig(rope_theta=10_000.0, window=4096, logit_softcap=50.0),
    post_norm=True, embed_scale=True,
    final_logit_softcap=30.0,
    tie_embeddings=True,
)

# Training takes the pure-FSDP layout; on one device that routes the loss
# through the chunked cross-entropy (``runtime.steps.train_par``).
PARALLEL = ParallelConfig(pure_fsdp_train=True)

"""codeqwen1.5-7b [dense] — qwen1.5 arch (qkv bias) [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import AttnConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13_440, vocab_size=92_416, head_dim=128,
    block_pattern=("attn",),
    attn=AttnConfig(rope_theta=1_000_000.0, qkv_bias=True),
    tie_embeddings=False,
)

# Training takes the pure-FSDP layout; on one device that routes the loss
# through the chunked cross-entropy (``runtime.steps.train_par``).
PARALLEL = ParallelConfig(pure_fsdp_train=True)

"""llama-3.2-vision-90b [vlm] — text backbone with gated cross-attn image
layers every 5th layer; the vision tower is a stub
(``runtime.steps.extras_specs`` gives precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28_672, vocab_size=128_256, head_dim=128,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    attn=AttnConfig(rope_theta=500_000.0),
    vision_dim=1280, num_patches=1600,
    tie_embeddings=False,
)

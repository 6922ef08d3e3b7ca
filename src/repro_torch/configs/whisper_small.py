"""whisper-small [audio] — enc-dec transformer backbone; the conv/mel
frontend is a stub: ``runtime.steps.extras_specs`` gives precomputed frame
embeddings (B, T_enc, d_model) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51_865, head_dim=64,
    block_pattern=("attn",),       # decoder pattern; encoder built separately
    attn=AttnConfig(use_rope=False),
    encoder_layers=12, decoder_len=448,
    tie_embeddings=True,
)

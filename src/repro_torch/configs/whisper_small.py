"""whisper-small [audio] — enc-dec 12L each, d768 12H(kv12) ff3072.

Conv frontend STUBBED: input_specs provides frame embeddings [B, S, 768].
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    enc_dec=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,        # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
)

"""command-r-plus-104b [dense] — 64L d12288 96H(kv8) ff33792 vocab 256000.

GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    activation="swiglu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=75e6,
)

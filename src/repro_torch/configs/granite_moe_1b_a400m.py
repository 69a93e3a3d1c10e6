"""granite-moe-1b-a400m [moe] — 24L d1024 16H(kv8) ff512/expert, 32e top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512),
)

"""mixtral-8x7b [moe] — 32L d4096 32H(kv8) ff14336, 8e top-2, SWA 4096.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
)

"""jamba-v0.1-52b [hybrid] — 32L d4096 32H(kv8) ff14336, 16e top-2 MoE,
Mamba:attention 1:7 interleave (attention at index 4 of each 8-layer block).

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    attn_every=8,
    attn_index=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
)

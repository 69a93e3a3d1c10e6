"""qwen2.5-14b [dense] — 48L d5120 40H(kv8) ff13824 vocab 152064, QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1e6,
)

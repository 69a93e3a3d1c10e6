"""rwkv6-7b [ssm] — Finch: 32L d4096 ff14336 vocab 65536, attention-free,
data-dependent per-channel decay. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv heads = d_model / 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    activation="sq_relu",
    norm="layernorm",
    ssm=SSMConfig(kind="rwkv6", rwkv_head_dim=64, rwkv_decay_lora=64),
)

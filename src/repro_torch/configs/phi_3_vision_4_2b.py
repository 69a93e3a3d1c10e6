"""phi-3-vision-4.2b [vlm] — phi3-mini backbone 32L d3072 32H(kv32) ff8192.

CLIP frontend STUBBED: input_specs provides patch embeddings [B, n_img, 1024]
(CLIP-L hidden) fed through a learned projector.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,   # MHA
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    norm="rmsnorm",
    n_img_tokens=1024,
    img_embed_dim=1024,
)

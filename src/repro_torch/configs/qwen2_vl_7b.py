"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE, dynamic-resolution vision frontend STUBBED (precomputed patch
embeddings fill the sequence prefix)  [arXiv:2409.12191]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, rope="mrope", mlp="swiglu", vision_prefix=True,
)

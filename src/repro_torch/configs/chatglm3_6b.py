"""chatglm3-6b [dense]: 28L d=4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
RoPE 2d (partial rotary), QKV bias  [arXiv:2406.12793]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, rope="partial", qkv_bias=True, mlp="swiglu",
)

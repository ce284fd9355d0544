"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm, head_dim=128  [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab=151936, d_head=128, qk_norm=True, rope="standard",
    rope_theta=1000000.0, mlp="swiglu",
)

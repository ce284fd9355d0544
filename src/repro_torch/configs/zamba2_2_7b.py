"""zamba2-2.7b [hybrid]: 54L Mamba-2 d=2560 + shared attention block
(32H kv=32, d_ff=10240) every 6 layers, vocab 32000, ssm_state=64
[arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, d_head=80, ssm="mamba2", d_state=64, d_conv=4, expand=2,
    ssm_head_dim=64, attn_every=6, rope="standard", mlp="swiglu",
)

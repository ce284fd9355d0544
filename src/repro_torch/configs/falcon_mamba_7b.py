"""falcon-mamba-7b [ssm]: 64L d_model=4096, attn-free Mamba-1, vocab 65024,
ssm_state=16  [arXiv:2410.05355]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_head=1,
    d_ff=0, vocab=65024, ssm="mamba1", d_state=16, d_conv=4, expand=2,
    rope="none", mlp="swiglu",   # attention/mlp fields unused (attn-free)
)

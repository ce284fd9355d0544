"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504,
encoder-only; conv waveform frontend STUBBED (precomputed frame
embeddings)  [arXiv:2106.07447]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, rope="none", causal=False, mlp="gelu", embed_inputs=True,
)

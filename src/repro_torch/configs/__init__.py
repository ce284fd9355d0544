"""Architecture registry: --arch <id> resolves here (the twin of
:mod:`repro.configs`, field for field)."""
from .base import (ModelConfig, ShapeConfig, SHAPES, cell_supported,
                   input_specs)

from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .chatglm3_6b import CONFIG as chatglm3_6b
from .qwen3_8b import CONFIG as qwen3_8b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .zamba2_2_7b import CONFIG as zamba2_2_7b
from .dbrx_132b import CONFIG as dbrx_132b
from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .hubert_xlarge import CONFIG as hubert_xlarge

ARCHS = {
    c.name: c for c in [
        falcon_mamba_7b, chatglm3_6b, qwen3_8b, qwen2_0_5b,
        phi3_mini_3_8b, zamba2_2_7b, dbrx_132b, olmoe_1b_7b,
        qwen2_vl_7b, hubert_xlarge,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses
    kw = dict(
        n_layers=2, d_model=64, vocab=256,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        d_head=16 if cfg.n_heads else 0,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.family == "moe":
        kw["n_experts"] = 4
        kw["top_k"] = 2
    if cfg.ssm:
        kw["d_state"] = min(cfg.d_state, 8)
        kw["ssm_head_dim"] = 16
    if cfg.family == "hybrid":
        kw["attn_every"] = 1
        kw["n_layers"] = 2
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)

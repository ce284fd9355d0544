"""Model/config schema for the assigned architectures and their shapes.

Every architecture is a :class:`ModelConfig`; every workload cell is a
(arch, :class:`ShapeConfig`) pair.  ``input_specs`` builds meta-device
tensors (shape and dtype, no storage) that stand in for a cell's inputs.
The twin of :mod:`repro.configs.base`, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # attention flavor
    rope: str = "standard"           # standard | partial | mrope | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True
    # mlp flavor
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM
    ssm: str = ""                    # "" | mamba1 | mamba2
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64           # mamba2 head dim
    # hybrid (zamba2): shared attention block applied every k SSM layers
    attn_every: int = 0
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # modality frontend stub: model consumes precomputed frame/patch embeds
    embed_inputs: bool = False       # audio: inputs are (B, S, D) embeddings
    vision_prefix: bool = False      # vlm: first S//4 positions come from
    #                                  precomputed patch embeddings
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank(self) -> int:
        return max(1, int(np.ceil(self.d_model / 16)))

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    @property
    def decoder(self) -> bool:
        """Has a decode step (hubert is encoder-only)."""
        return self.family != "audio"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, K, dh = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * D                              # embedding
        if not self.tie_embeddings:
            total += V * D                         # lm head
        attn = D * (H * dh) + 2 * D * (K * dh) + (H * dh) * D
        if self.qkv_bias:
            attn += (H + 2 * K) * dh
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        mlp = mlp_mult * D * F
        if self.family in ("dense", "vlm", "audio"):
            total += self.n_layers * (attn + mlp + 2 * D)
        elif self.family == "moe":
            total += self.n_layers * (attn + self.n_experts * mlp + D * self.n_experts + 2 * D)
        elif self.family == "ssm":
            total += self.n_layers * (self._mamba1_params() + D)
        elif self.family == "hybrid":
            total += self.n_layers * (self._mamba2_params() + D)
            total += attn + mlp + 2 * D            # one shared block
        return total

    def _mamba1_params(self) -> int:
        D, Di, N, R = self.d_model, self.d_inner, self.d_state, self.dt_rank
        return (D * 2 * Di + self.d_conv * Di + Di * (R + 2 * N) +
                R * Di + Di * N + Di + Di * D)

    def _mamba2_params(self) -> int:
        D, Di, N = self.d_model, self.d_inner, self.d_state
        Hs = self.n_ssm_heads
        return (D * (2 * Di + 2 * N + Hs) + self.d_conv * (Di + 2 * N) +
                Hs + Hs + Di + Di * D)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mlp = 3 * D * F if self.mlp in ("swiglu", "geglu") else 2 * D * F
        dense = self.param_count() - self.n_layers * self.n_experts * mlp
        return dense + self.n_layers * self.top_k * mlp


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a defined cell; reason if not."""
    if shape.kind == "decode" and not cfg.decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention"
    return True, ""


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of this cell.

    For decode cells the specs describe ONE serve_step invocation: a single
    new token per sequence plus the persistent cache state (which is passed
    separately).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.embed_inputs:                      # audio stub frontend
            specs = {"embeds": spec((B, S, cfg.d_model), f)}
        else:
            specs = {"tokens": spec((B, S), i32)}
            if cfg.vision_prefix:                 # vlm stub frontend
                specs["vision_embeds"] = spec((B, S // 4, cfg.d_model), f)
        if shape.kind == "train":
            specs["labels"] = spec((B, S), i32)
        return specs
    # decode: one new token, plus current positions
    return {
        "tokens": spec((B, 1), i32),
        "positions": spec((B,), i32),
    }

"""Roofline cost model: per-stage FLOPs / bytes for an architecture cell.

Task weights for the HVLB_CC placement are stage *compute volumes* (FLOPs);
edge volumes are activation bytes crossing stage boundaries; processor
execution rates are slice FLOP/s — the paper's ``comp = w / mu`` (Eq. 1)
becomes ``time = FLOPs / (gpus * peak * mfu)``.

Twin of :mod:`repro.planner.cost_model`: the same arithmetic in the same
order, so every cost equals the reference's.  Only :class:`HW` differs:
its constants are an NVIDIA H100 SXM's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM constants (per GPU / per link).  Every field but
    ``mfu`` is a data-sheet peak, not a measurement."""
    peak_flops: float = 989e12          # dense bf16 tensor core, data sheet
    hbm_bw: float = 3.35e12             # HBM3 bytes/s, data sheet
    nvlink_bw: float = 25e9             # NVLink 4, bytes/s a link a direction
    nvlink_links: int = 18              # NVLink 4 links per GPU, data sheet
    net_bw: float = 50e9                # 400 Gb/s NIC per GPU (DGX H100)
    mfu: float = 0.5                    # assumed sustained fraction


def _attn_flops(cfg: ModelConfig, tokens: int, kv_len: int) -> float:
    H, dh = cfg.n_heads, cfg.head_dim
    K = cfg.n_kv_heads
    D = cfg.d_model
    proj = 2 * tokens * D * (H * dh) * 2 + 2 * tokens * D * (K * dh) * 2
    scores = 2 * tokens * kv_len * H * dh * 2        # qk + av
    return proj + scores


def _mlp_flops(cfg: ModelConfig, tokens: int) -> float:
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    return 2 * tokens * cfg.d_model * cfg.d_ff * mult


def _moe_flops(cfg: ModelConfig, tokens: int) -> float:
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    expert = 2 * tokens * cfg.top_k * cfg.d_model * cfg.d_ff * mult
    router = 2 * tokens * cfg.d_model * cfg.n_experts
    return expert + router


def _mamba1_flops(cfg: ModelConfig, tokens: int) -> float:
    D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    proj = 2 * tokens * D * 2 * Di + 2 * tokens * Di * D
    lowrank = 2 * tokens * Di * (R + 2 * N) + 2 * tokens * R * Di
    scan = tokens * Di * N * 6                      # recurrence+readout
    return proj + lowrank + scan


def _mamba2_flops(cfg: ModelConfig, tokens: int) -> float:
    D, Di, N = cfg.d_model, cfg.d_inner, cfg.d_state
    Hs = cfg.n_ssm_heads
    proj = 2 * tokens * D * (2 * Di + 2 * N + Hs) + 2 * tokens * Di * D
    chunk = 256
    ssd = (2 * tokens * chunk * N            # C B^T scores
           + 2 * tokens * chunk * cfg.ssm_head_dim * Hs / max(Hs, 1)
           + 6 * tokens * Di * N / chunk)
    return proj + ssd * Hs


def layer_costs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """FLOPs per single layer/block and activation bytes per boundary."""
    if shape.kind == "decode":
        tokens = shape.global_batch                  # one token per seq
        kv_len = shape.seq_len
    else:
        tokens = shape.global_batch * shape.seq_len
        kv_len = shape.seq_len
    act_bytes = tokens * cfg.d_model * 2             # bf16 boundary tensor
    out: Dict[str, float] = {"act_bytes": float(act_bytes)}
    if cfg.family in ("dense", "vlm", "audio"):
        out["block"] = _attn_flops(cfg, tokens, kv_len) + _mlp_flops(cfg, tokens)
    elif cfg.family == "moe":
        out["block"] = _attn_flops(cfg, tokens, kv_len) + _moe_flops(cfg, tokens)
    elif cfg.family == "ssm":
        out["block"] = _mamba1_flops(cfg, tokens)
    elif cfg.family == "hybrid":
        out["block"] = _mamba2_flops(cfg, tokens)
        out["shared_attn"] = (_attn_flops(cfg, tokens, kv_len) +
                              _mlp_flops(cfg, tokens))
    emb = 2 * tokens * cfg.d_model * cfg.vocab
    out["embed"] = 2 * tokens * cfg.d_model          # table lookup ~ O(T*D)
    out["head"] = float(emb)
    if shape.kind == "train":
        # backward ~ 2x forward for matmul-dominated blocks
        for k in ("block", "shared_attn", "head"):
            if k in out:
                out[k] = out[k] * 3.0
    return out


def total_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic whole-step FLOPs (global, all GPUs): the roofline's
    compute term."""
    c = layer_costs(cfg, shape)
    L = cfg.n_layers
    f = c["block"] * L + c["embed"] + c["head"]
    if cfg.family == "hybrid" and cfg.attn_every:
        f += c["shared_attn"] * (L // cfg.attn_every)
    return float(f)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6·N·D / 2·N·D convention (N = active params, D = tokens)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token/seq


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic whole-step HBM traffic (global bytes, all GPUs).

    Weights: fp32 master read + bf16 cast write/read fwd+bwd, grad write,
    two Adam moments read+write.  Activations: layer boundary tensors plus
    recompute traffic under remat.  Decode: params + full cache sweep.
    """
    from ..models.params import param_bytes as _pb
    pb = float(_pb(cfg))                          # fp32 master bytes
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        weight_traffic = pb * (2 + 1 + 4) + pb / 2 * 2   # masters+adam+bf16
        act_traffic = L * tokens * D * 2 * 8             # carry+internals
        head_traffic = tokens * V * 4 * 3                # logits fwd+bwd
        return weight_traffic + act_traffic + head_traffic
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        weight_traffic = pb / 2                          # bf16 read once
        act_traffic = L * tokens * D * 2 * 4
        kv_traffic = (L * tokens * cfg.n_kv_heads * cfg.head_dim * 2 * 2
                      if cfg.has_attention else 0)
        return weight_traffic + act_traffic + tokens * V * 4 + kv_traffic
    # decode
    B, S = shape.global_batch, shape.seq_len
    weight_traffic = pb / 2
    if cfg.family in ("dense", "vlm", "moe"):
        cache = 2 * L * B * S * cfg.n_kv_heads * cfg.head_dim * 2
    elif cfg.family == "ssm":
        cache = L * B * cfg.d_inner * cfg.d_state * 4 * 2
    else:                                               # hybrid
        G = L // cfg.attn_every
        cache = (2 * G * B * S * cfg.n_kv_heads * cfg.head_dim * 2 +
                 L * B * cfg.n_ssm_heads * cfg.ssm_head_dim *
                 cfg.d_state * 4 * 2)
    return weight_traffic + cache + B * V * 4


def stage_graph_costs(cfg: ModelConfig, shape: ShapeConfig,
                      n_stage_units: int = 16) -> Tuple[List[float], float]:
    """Collapse the layer chain into ~n_stage_units stage weights (FLOPs)
    plus the boundary activation bytes."""
    c = layer_costs(cfg, shape)
    L = cfg.n_layers
    per_unit = max(1, L // n_stage_units)
    units: List[float] = []
    i = 0
    while i < L:
        span = min(per_unit, L - i)
        w = c["block"] * span
        if cfg.family == "hybrid" and cfg.attn_every:
            n_shared = sum(1 for j in range(i, i + span)
                           if (j + 1) % cfg.attn_every == 0)
            w += c["shared_attn"] * n_shared
        units.append(w)
        i += span
    return units, c["act_bytes"]

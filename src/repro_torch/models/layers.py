"""Model layers in plain PyTorch, the twin of :mod:`repro.models.layers`
(its dense and attention layers; the MoE and Mamba layers come with
their families, ``ROADMAP.md`` queue 1).

The algebra is the reference's, step for step: attention scores and
softmax in f32 with the mask value -1e30, the weights cast to v's dtype
before P·V, ``rms_norm`` through f32 and back, SiLU and the tanh GELU
written as ``jax.nn`` composes them, so a bf16 activation rounds where
the reference's does.  Functions take plain dicts of tensors.
The reference's ``shard`` constraints are no-ops without a mesh and have
no counterpart here.  A cached decode writes its token's k and v into
the cache in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

# Query-chunk size above which attention switches to the memory-bounded
# online-softmax path (the reference's values).
ATTN_CHUNK_THRESHOLD = 8192
ATTN_CHUNK = 2048
# mask value of a score that must get no weight
MASKED = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


# ----------------------------------------------------------------- rotary
def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2)."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device)
    freqs = 1.0 / (theta ** (ar / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (even, odd) of the last dim; cos/sin (..., d/2)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,dh), k (B,S,K,dh), positions (B,S) integers."""
    dh = cfg.head_dim
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "standard":
        cos, sin = _rope_angles(positions, dh, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)
    if cfg.rope == "partial":
        # chatglm-style 2d RoPE: rotary on the first half of head_dim.
        rd = dh // 2
        cos, sin = _rope_angles(positions, rd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = torch.cat([_apply_rot(q[..., :rd], cos, sin), q[..., rd:]], -1)
        k = torch.cat([_apply_rot(k[..., :rd], cos, sin), k[..., rd:]], -1)
        return q, k
    if cfg.rope == "mrope":
        # qwen2-vl M-RoPE: head_dim split into (t, h, w) sections with
        # separate position streams (stub: derived from the 1-d position,
        # in integer arithmetic).
        sec = dh // 2 // 4                      # quarters: 2t, 1h, 1w
        pos_t = positions
        pos_h = positions // 64
        pos_w = positions % 64
        cos_t, sin_t = _rope_angles(pos_t, dh, cfg.rope_theta)
        cos_h, sin_h = _rope_angles(pos_h, dh, cfg.rope_theta)
        cos_w, sin_w = _rope_angles(pos_w, dh, cfg.rope_theta)
        idx = torch.arange(dh // 2, device=positions.device)
        sel_h = (idx >= 2 * sec) & (idx < 3 * sec)
        sel_w = idx >= 3 * sec
        cos = torch.where(sel_h, cos_h, torch.where(sel_w, cos_w, cos_t))
        sin = torch.where(sel_h, sin_h, torch.where(sel_w, sin_w, sin_t))
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)
    raise ValueError(f"unknown rope variant {cfg.rope!r}")


# -------------------------------------------------------------- attention
def _qk_norm(q, k, p, eps):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return q, k


def _weighted_values(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(scores (B,K,G,Sq,Sk), f32) · v (B,Sk,K,dh) -> (B,Sq,K,G,dh),
    the weights cast to v's dtype first."""
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)


def _sdpa_full(q, k, v, causal: bool, q_offset) -> torch.Tensor:
    """q (B,Sq,K,G,dh), k/v (B,Sk,K,dh) -> (B,Sq,K,G,dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float() * scale, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, MASKED)
    return _weighted_values(scores, v)


def _sdpa_chunked(q, k, v, causal: bool) -> torch.Tensor:
    """Softmax over query chunks of ATTN_CHUNK rows: O(S*C) score memory
    instead of O(S^2), each chunk exact against all keys."""
    B, S, K, G, dh = q.shape
    C = ATTN_CHUNK
    scale = 1.0 / math.sqrt(dh)
    kf = k.float()
    keys = torch.arange(S, device=q.device)
    outs = []
    for i in range(S // C):
        qi = q[:, i * C:(i + 1) * C]
        scores = torch.einsum("bqkgh,bskh->bkgqs", qi.float() * scale, kf)
        if causal:
            qpos = i * C + torch.arange(C, device=q.device)
            scores = scores.masked_fill(~(qpos[:, None] >= keys[None, :]),
                                        MASKED)
        outs.append(_weighted_values(scores, v))
    return torch.cat(outs, dim=1)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Params] = None,
              cache_pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  Train/prefill: cache is None.  Decode: x is (B,1,D)
    and (cache, cache_pos) carry one layer's KV cache (B, S_max, K, dh)
    and the current positions; the token's k and v are written into the
    cache in place at ``cache_pos[0]`` (positions are uniform across the
    batch, as the reference assumes) and the cache is returned."""
    B, S, D = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q, k = _qk_norm(q, k, p, cfg.norm_eps)
    q, k = apply_rope(cfg, q, k, positions)
    qg = q.reshape(B, S, K, G, dh)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        idx = cache_pos[:1].long()
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv}
        scale = 1.0 / math.sqrt(dh)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float() * scale,
                              ck.float())
        Sk = ck.shape[1]
        mask = torch.arange(Sk, device=x.device)[None, :] \
            <= cache_pos[:, None]                            # (B, Sk)
        scores = scores.masked_fill(~mask[:, None, None, None, :], MASKED)
        out = _weighted_values(scores, cv)
    elif S > ATTN_CHUNK_THRESHOLD and S % ATTN_CHUNK == 0:
        out = _sdpa_chunked(qg, k, v, cfg.causal)
    else:
        out = _sdpa_full(qg, k, v, cfg.causal, 0)

    out = out.reshape(B, S, H * dh)
    out = torch.einsum("bsh,hd->bsd", out, p["wo"])
    return out, new_cache


# -------------------------------------------------------------------- mlp
def _as(x: torch.Tensor, c: float) -> float:
    """``c`` rounded to ``x``'s dtype, as JAX rounds a constant it
    combines with an array."""
    return float(torch.tensor(c, dtype=x.dtype))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · logistic(x), the logistic as 1 / (1 + e^-x),
    each operation rounded to x's dtype as XLA evaluates it."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form, its default), operation for operation;
    x³ is x · (x · x), as ``lax.integer_pow`` expands it."""
    inner = x + _as(x, 0.044715) * (x * (x * x))
    cdf = 0.5 * (1.0 + torch.tanh(_as(x, math.sqrt(2 / math.pi)) * inner))
    return x * cdf


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = _silu if cfg.mlp == "swiglu" else _gelu
        h = act(torch.einsum("bsd,df->bsf", x, p["w_gate"])) * \
            torch.einsum("bsd,df->bsf", x, p["w_up"])
    else:
        h = _gelu(torch.einsum("bsd,df->bsf", x, p["w_up"]))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])

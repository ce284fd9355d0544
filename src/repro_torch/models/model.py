"""The model: forward and decode, the twin of :mod:`repro.models.model`
for the families whose layers are ported (``dense``, ``vlm`` and the
encoder-only ``audio``; decode for ``dense`` and ``vlm``).  The ``moe``,
``ssm`` and ``hybrid`` families raise ``NotImplementedError``: their
layers are queued in ``ROADMAP.md`` (queue 1 item 4).

The reference scans a stacked layer axis; here a Python loop walks it,
one layer's views at a time.  A decode step writes the new token's k
and v into the cache in place and returns the same cache dict.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import attention, mlp, rms_norm
from .params import ParamSpec, tree_map

Tree = Dict[str, Any]

_PORTED = ("dense", "vlm", "audio")
_DECODE_PORTED = ("dense", "vlm")


def _require(cfg: ModelConfig, families: Sequence[str], what: str) -> None:
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's {what} is not ported "
            f"yet (ROADMAP.md, queue 1 item 4)")
    if cfg.family not in families:
        raise ValueError(f"{cfg.name} ({cfg.family}) has no {what}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """f32 leaves in ``dtype`` (``.to`` returns a leaf that is already in
    it unchanged); other leaves as they are."""
    return tree_map(
        lambda a: a.to(dtype) if a.dtype == torch.float32 else a, tree)


def layer_params(blocks: Tree, n_layers: int) -> List[Tree]:
    """Each layer's parameters, as views into the stacked ``blocks``."""
    return [tree_map(lambda a, i=i: a[i], blocks) for i in range(n_layers)]


def _embed_tokens(cfg: ModelConfig, params: Tree,
                  batch: Tree) -> torch.Tensor:
    f = _dtype(cfg)
    if cfg.embed_inputs:
        return batch["embeds"].to(f)
    x = F.embedding(batch["tokens"].long(), params["embed"]).to(f)
    if cfg.vision_prefix and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(f)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def _dense_block(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h, _ = attention(cfg, p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                     positions)
    x = x + h
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp(cfg, p["mlp"], xn)


def _logits(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, head).float()


def forward(cfg: ModelConfig, params: Tree, batch: Tree) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V) in f32."""
    _require(cfg, _PORTED, "forward")
    params = _cast(params, _dtype(cfg))
    x = _embed_tokens(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for p in layer_params(params["blocks"], cfg.n_layers):
        x = _dense_block(cfg, p, x, positions)
    return _logits(cfg, params, x)


# ------------------------------------------------------------------ decode
def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Tree:
    """ParamSpec tree for the decode state: the KV cache of the families
    whose decode step is ported."""
    _require(cfg, _DECODE_PORTED, "decode state")
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ax = ("layers", "batch", "cache_seq", None, None)
    spec = ParamSpec((L, batch, max_seq, K, dh), ax, "zeros", _dtype(cfg))
    return {"k": spec, "v": spec}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: Union[str, torch.device] = "cuda") -> Tree:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, max_seq))


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree,
                tokens: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Tree]:
    """One serve step: tokens (B, 1), positions (B,) -> logits (B, 1, V);
    the cache is updated in place and returned."""
    _require(cfg, _DECODE_PORTED, "decode step")
    params = _cast(params, _dtype(cfg))
    x = _embed_tokens(cfg, params, {"tokens": tokens})
    pos2d = positions[:, None]
    for i, p in enumerate(layer_params(params["blocks"], cfg.n_layers)):
        xn = rms_norm(x, p["norm1"], cfg.norm_eps)
        h, _ = attention(cfg, p["attn"], xn, pos2d,
                         cache={"k": cache["k"][i], "v": cache["v"][i]},
                         cache_pos=positions)
        h = x + h
        xn = rms_norm(h, p["norm2"], cfg.norm_eps)
        x = h + mlp(cfg, p["mlp"], xn)
    return _logits(cfg, params, x), cache

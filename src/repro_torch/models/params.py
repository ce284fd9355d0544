"""Parameter specs: one source of truth for shapes, logical sharding axes
and initializers, and the tensors made from them.

Twin of :mod:`repro.models.params`.  ``ParamSpec.axes`` keeps the
reference's logical axis names; under a mesh (``sharding.use_sharding``)
:func:`param_shardings` turns them into DTensor placements and
:func:`distribute_params` lays a tree out by them, and
:func:`abstract_params` gives meta tensors for the dry run.
``param_specs`` covers every family, because the planner's cost model
(``planner/cost_model.py::hbm_bytes``) sizes every architecture's
weights through :func:`param_bytes`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from .sharding import distribute, param_sharding

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | a_log | dt_bias
    dtype: torch.dtype = torch.float32


def _attn_specs(cfg: ModelConfig, L: Optional[int]) -> Tree:
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pre = (L,) if L else ()
    lax = ("layers",) if L else ()
    s: Tree = {
        "wq": ParamSpec(pre + (D, H, dh), lax + ("p_in", "p_heads", None)),
        "wk": ParamSpec(pre + (D, K, dh), lax + ("p_in", "p_kv_heads", None)),
        "wv": ParamSpec(pre + (D, K, dh), lax + ("p_in", "p_kv_heads", None)),
        "wo": ParamSpec(pre + (H * dh, D), lax + ("p_ff", "p_in")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(pre + (H, dh), lax + ("p_heads", None), "zeros")
        s["bk"] = ParamSpec(pre + (K, dh), lax + ("p_kv_heads", None), "zeros")
        s["bv"] = ParamSpec(pre + (K, dh), lax + ("p_kv_heads", None), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec(pre + (dh,), lax + (None,), "ones")
        s["k_norm"] = ParamSpec(pre + (dh,), lax + (None,), "ones")
    return s


def _mlp_specs(cfg: ModelConfig, L: Optional[int]) -> Tree:
    D, F = cfg.d_model, cfg.d_ff
    pre = (L,) if L else ()
    lax = ("layers",) if L else ()
    s: Tree = {
        "w_up": ParamSpec(pre + (D, F), lax + ("p_in", "p_ff")),
        "w_down": ParamSpec(pre + (F, D), lax + ("p_ff", "p_in")),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        s["w_gate"] = ParamSpec(pre + (D, F), lax + ("p_in", "p_ff"))
    return s


def _moe_specs(cfg: ModelConfig, L: Optional[int]) -> Tree:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pre = (L,) if L else ()
    lax = ("layers",) if L else ()
    s: Tree = {
        "w_router": ParamSpec(pre + (D, E), lax + ("p_in", None)),
        "w_up": ParamSpec(pre + (E, D, F), lax + ("p_experts", "p_in", "p_ff")),
        "w_down": ParamSpec(pre + (E, F, D), lax + ("p_experts", "p_ff", "p_in")),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        s["w_gate"] = ParamSpec(pre + (E, D, F),
                                lax + ("p_experts", "p_in", "p_ff"))
    return s


def _mamba1_specs(cfg: ModelConfig, L: int) -> Tree:
    D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    k = cfg.d_conv
    pre, lax = (L,), ("layers",)
    return {
        "w_in": ParamSpec(pre + (D, 2 * Di), lax + ("p_in", "p_ssm_inner")),
        "conv_w": ParamSpec(pre + (k, Di), lax + (None, "p_ssm_inner")),
        "conv_b": ParamSpec(pre + (Di,), lax + ("p_ssm_inner",), "zeros"),
        "w_x": ParamSpec(pre + (Di, R + 2 * N), lax + ("p_ssm_inner", None)),
        "w_dt": ParamSpec(pre + (R, Di), lax + (None, "p_ssm_inner")),
        "dt_bias": ParamSpec(pre + (Di,), lax + ("p_ssm_inner",), "dt_bias"),
        "A_log": ParamSpec(pre + (Di, N), lax + ("p_ssm_inner", None), "a_log"),
        "D_skip": ParamSpec(pre + (Di,), lax + ("p_ssm_inner",), "ones"),
        "w_out": ParamSpec(pre + (Di, D), lax + ("p_ssm_inner", "p_in")),
        "norm": ParamSpec(pre + (D,), lax + (None,), "ones"),
    }


def _mamba2_specs(cfg: ModelConfig, shape_pre: Tuple[int, ...]) -> Tree:
    D, Di, N = cfg.d_model, cfg.d_inner, cfg.d_state
    Hs, k = cfg.n_ssm_heads, cfg.d_conv
    pre = shape_pre
    lax = ("layers",) * len(shape_pre)
    dproj = 2 * Di + 2 * N + Hs
    return {
        "w_in": ParamSpec(pre + (D, dproj), lax + ("p_in", None)),
        "conv_w": ParamSpec(pre + (k, Di + 2 * N), lax + (None, None)),
        "conv_b": ParamSpec(pre + (Di + 2 * N,), lax + (None,), "zeros"),
        "dt_bias": ParamSpec(pre + (Hs,), lax + (None,), "dt_bias"),
        "A_log": ParamSpec(pre + (Hs,), lax + (None,), "a_log"),
        "D_skip": ParamSpec(pre + (Hs,), lax + (None,), "ones"),
        "out_norm": ParamSpec(pre + (Di,), lax + (None,), "ones"),
        "w_out": ParamSpec(pre + (Di, D), lax + ("p_ssm_inner", "p_in")),
        "norm": ParamSpec(pre + (D,), lax + (None,), "ones"),
    }


def param_specs(cfg: ModelConfig) -> Tree:
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    specs: Tree = {
        "embed": ParamSpec((V, D), ("p_vocab", "p_embed")),
        "final_norm": ParamSpec((D,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((V, D), ("p_vocab", "p_embed"))
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        blocks: Tree = {
            "attn": _attn_specs(cfg, L),
            "norm1": ParamSpec((L, D), ("layers", None), "ones"),
            "norm2": ParamSpec((L, D), ("layers", None), "ones"),
        }
        blocks["mlp" if cfg.family != "moe" else "moe"] = (
            _mlp_specs(cfg, L) if cfg.family != "moe" else _moe_specs(cfg, L))
        specs["blocks"] = blocks
    elif cfg.family == "ssm":
        specs["blocks"] = _mamba1_specs(cfg, L)
    elif cfg.family == "hybrid":
        n_groups = L // cfg.attn_every
        specs["blocks"] = _mamba2_specs(cfg, (n_groups, cfg.attn_every))
        specs["shared"] = {
            "attn": _attn_specs(cfg, None),
            "mlp": _mlp_specs(cfg, None),
            "norm1": ParamSpec((D,), (None,), "ones"),
            "norm2": ParamSpec((D,), (None,), "ones"),
        }
    else:
        raise ValueError(cfg.family)
    return specs


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied to every leaf of a nested dict (with the leaves at
    the same keys of ``rest``, trees of the same structure), keys kept,
    leaf by leaf in :func:`tree_leaves`' order."""
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            if isinstance(tree[k], dict)
            else fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of a nested dict in sorted key order (the order
    ``jax.tree.leaves`` gives a dict tree)."""
    out: List[Any] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    kw = dict(dtype=spec.dtype, device=device)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / np.sqrt(max(1, fan_in))
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(float(scale)).to(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, **kw)
    if spec.init == "ones":
        return torch.ones(spec.shape, **kw)
    if spec.init == "a_log":
        n = spec.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device))
        return base.expand(spec.shape).to(spec.dtype).contiguous()
    if spec.init == "dt_bias":
        val = float(np.log(np.expm1(0.01)))
        return torch.full(spec.shape, val, **kw)
    raise ValueError(spec.init)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda") -> Tree:
    """Random f32 master weights on ``device`` (the card unless the
    caller asks for the CPU), by the reference's rules: ``normal``
    leaves are N(0, 1) / sqrt(fan_in), the others constants.  The draws
    come from ``generator`` (one on ``device``; seed 0 when omitted),
    leaf by leaf in sorted key order; they are not the reference's
    draws (``params_from_jax`` carries those across)."""
    from ..core.backends.cuda import check_device
    dev = check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return tree_map(lambda s: _init_leaf(s, generator, dev),
                    param_specs(cfg))


def param_bytes(cfg: ModelConfig) -> int:
    specs = tree_leaves(param_specs(cfg))
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in specs)


def abstract_params(cfg: ModelConfig) -> Tree:
    """The parameter tree as meta tensors: shapes and dtypes, no data."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), param_specs(cfg))


def param_shardings(cfg: ModelConfig) -> Tree:
    """Each parameter's placements on the active mesh (None leaves
    without one)."""
    return tree_map(lambda s: param_sharding(s.axes, s.shape),
                    param_specs(cfg))


def distribute_params(cfg: ModelConfig, params: Tree) -> Tree:
    """``params``, a whole tree every rank holds, as DTensors laid out by
    :func:`param_shardings` on the active mesh, each rank keeping its
    own shards."""
    return tree_map(distribute, params, param_shardings(cfg))

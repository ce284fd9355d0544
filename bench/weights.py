"""The cell's weights, made from the seed on the device in the type they
are served in (bf16), one draw a stacked leaf.

The tree has the serving program's layout (its keys and stacked layer
axis); the plain references read the same tensors.  Matrices are
N(0, 1 / fan_in) with fan_in the width each one reads, the embedding
N(0, 1) (N(0, 1 / D) where it is tied to the head, as the head reads
it), norms and the Mamba skip 1, the Mamba decay log(1..N) and its
step bias log(expm1(0.01)), as the Mamba paper initialises them.  A
model with tied embeddings has no ``lm_head``: :func:`head` is the
embedding.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# a leaf: (shape, init, fan_in)
Spec = Tuple[Tuple[int, ...], str, int]


def _attn(m: dict) -> Dict[str, Spec]:
    L, D, H, K = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"]
    dh = m.get("d_head") or D // H
    tree = {"wq": ((L, D, H, dh), "normal", D),
            "wk": ((L, D, K, dh), "normal", D),
            "wv": ((L, D, K, dh), "normal", D),
            "wo": ((L, H * dh, D), "normal", H * dh)}
    if m.get("qk_norm"):
        tree["q_norm"] = ((L, dh), "ones", 0)
        tree["k_norm"] = ((L, dh), "ones", 0)
    return tree


def specs(m: dict) -> dict:
    """The leaves of a model of family ``dense``, ``moe`` or ``ssm``."""
    L, D, V = m["n_layers"], m["d_model"], m["vocab"]
    tied = bool(m.get("tie_embeddings"))
    # a tied embedding is also the head, which reads the width D
    tree: dict = {"embed": ((V, D), "normal", D if tied else 1),
                  "final_norm": ((D,), "ones", 0)}
    if not tied:
        tree["lm_head"] = ((V, D), "normal", D)
    if m["family"] == "dense":
        F = m["d_ff"]
        tree["blocks"] = {
            "attn": _attn(m),
            "norm1": ((L, D), "ones", 0), "norm2": ((L, D), "ones", 0),
            "mlp": {"w_gate": ((L, D, F), "normal", D),
                    "w_up": ((L, D, F), "normal", D),
                    "w_down": ((L, F, D), "normal", F)}}
    elif m["family"] == "moe":
        E, F = m["n_experts"], m["d_ff"]
        tree["blocks"] = {
            "attn": _attn(m),
            "norm1": ((L, D), "ones", 0), "norm2": ((L, D), "ones", 0),
            "moe": {"w_router": ((L, D, E), "normal", D),
                    "w_gate": ((L, E, D, F), "normal", D),
                    "w_up": ((L, E, D, F), "normal", D),
                    "w_down": ((L, E, F, D), "normal", F)}}
    elif m["family"] == "ssm":
        Di = m.get("expand", 2) * D
        N, k = m["d_state"], m["d_conv"]
        R = max(1, math.ceil(D / 16))
        tree["blocks"] = {
            "w_in": ((L, D, 2 * Di), "normal", D),
            "conv_w": ((L, k, Di), "normal", k),
            "conv_b": ((L, Di), "zeros", 0),
            "w_x": ((L, Di, R + 2 * N), "normal", Di),
            "w_dt": ((L, R, Di), "normal", R),
            "dt_bias": ((L, Di), "dt_bias", 0),
            "A_log": ((L, Di, N), "a_log", 0),
            "D_skip": ((L, Di), "ones", 0),
            "w_out": ((L, Di, D), "normal", Di),
            "norm": ((L, D), "ones", 0)}
    else:
        raise ValueError(f"no weights for family {m['family']!r}")
    return tree


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


def _leaf(spec: Spec, gen: torch.Generator, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    shape, init, fan_in = spec
    kw = dict(dtype=dtype, device=device)
    if init == "normal":
        x = torch.randn(shape, generator=gen, **kw)
        return x if fan_in == 1 else x.mul_(1.0 / math.sqrt(fan_in))
    if init == "zeros":
        return torch.zeros(shape, **kw)
    if init == "ones":
        return torch.ones(shape, **kw)
    if init == "a_log":
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device)).to(
            dtype).expand(shape).contiguous()
    if init == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)), **kw)
    raise ValueError(init)


def make(m: dict, seed: int, device: torch.device) -> dict:
    """The weights of model ``m`` drawn from ``seed`` on ``device`` in the
    model's dtype, leaf by leaf in sorted key order from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    dtype = DTYPES[m["dtype"]]

    def build(tree: dict) -> dict:
        return {k: build(tree[k]) if isinstance(tree[k], dict)
                else _leaf(tree[k], gen, device, dtype) for k in sorted(tree)}

    return build(specs(m))


def head(w: dict) -> torch.Tensor:
    """The output head (V, D): ``lm_head``, or the embedding where tied."""
    return w["lm_head"] if "lm_head" in w else w["embed"]


def leaves(tree: dict):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))

"""Gradient compression, the twin of :mod:`repro.optim.compress`: int8
quantization with one scale a tensor and error feedback (the residual
is carried to the next step).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes and scales equal the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.params import Tree, tree_map


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.max(torch.abs(g)) + 1e-12
    scale = a / 127.0
    qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return qi, scale


def compress_grads(grads: Tree, residual: Optional[Tree] = None
                   ) -> Tuple[Tree, Tree, Tree]:
    """Returns (q_int8, scales, new_residual)."""
    if residual is not None:
        grads = tree_map(lambda g, r: g + r, grads, residual)
    pairs = tree_map(_quantize, grads)
    qi = tree_map(lambda q: q[0], pairs)
    sc = tree_map(lambda q: q[1], pairs)
    new_res = tree_map(lambda g, d: g - d, grads, decompress_grads(qi, sc))
    return qi, sc, new_res


def decompress_grads(qi: Tree, scales: Tree) -> Tree:
    return tree_map(lambda i, s: i.to(torch.float32) * s, qi, scales)

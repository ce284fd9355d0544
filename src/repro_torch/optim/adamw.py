"""AdamW with global-norm clipping and a linear-warmup cosine schedule,
the twin of :mod:`repro.optim.adamw` (not ``torch.optim.AdamW``, which
places the weight decay and the bias correction differently).

The state is ``OptState(mu, nu, step)``: ``mu`` and ``nu`` are f32 trees
shaped like the parameters (f64 for f64 parameters, the exact witness
of the f32 checks), ``step`` an int32 scalar.  Every function maps
trees to new trees and writes nothing it was given.  The schedule and
the bias corrections are f32 tensor arithmetic, as the reference
computes them.

Under a mesh the leaves are DTensors: ``mu`` and ``nu`` are laid out
like their parameter (``opt_shardings``), the step is replicated, the
grad norm is the global one, and each leaf's update runs on the rank's
own shards of the parameter, its gradient and its moments, which must
all have the parameter's placements (a gradient still ``Partial`` over
a mesh axis raises).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..configs.base import ModelConfig
from ..models.params import ParamSpec, Tree, param_specs, tree_leaves, \
    tree_map
from ..models.sharding import full


class OptState(NamedTuple):
    mu: Tree
    nu: Tree
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the optimizer computes a leaf of ``dtype`` in: f32, or
    f64 for an f64 leaf."""
    return torch.promote_types(dtype, torch.float32)


def init_opt_state(params: Tree) -> OptState:
    """Zero moments laid out like the parameters, step 0 (replicated on
    the parameters' mesh when they are DTensors)."""
    z = tree_map(lambda p: torch.zeros_like(p, dtype=_wide(p.dtype)),
                 params)
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim,
                                 src_data_rank=None)
    return OptState(z, tree_map(torch.clone, z), step)


def abstract_opt_state(cfg: ModelConfig) -> OptState:
    """The optimizer state as meta tensors (f32 moments, int32 step)."""
    ab = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                        device="meta"), param_specs(cfg))
    return OptState(ab, tree_map(torch.empty_like, ab),
                    torch.empty((), dtype=torch.int32, device="meta"))


def opt_state_specs(cfg: ModelConfig) -> OptState:
    """ParamSpec trees (for shardings) mirroring the parameter layout."""
    f32 = tree_map(lambda s: ParamSpec(s.shape, s.axes, s.init,
                                       torch.float32), param_specs(cfg))
    return OptState(f32, tree_map(lambda s: s, f32), ParamSpec((), ()))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp_max((step + 1.0) / cfg.warmup_steps, 1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (in f32, f64 for f64
    leaves), the leaves summed in :func:`tree_leaves` order; a DTensor
    leaf's sum is over all its shards (every rank must call)."""
    return torch.sqrt(sum(full(torch.sum(g.to(_wide(g.dtype)) ** 2))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(opt_cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    scale = torch.clamp_max(opt_cfg.clip_norm / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = full(_schedule(opt_cfg, state.step))
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    t = full(step).to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
             v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not isinstance(p, DTensor):
            return local(p, g, m, v)
        for name, x in (("gradient", g), ("mu", m), ("nu", v)):
            if x.placements != p.placements:
                raise ValueError(f"AdamW: the {name} is laid out "
                                 f"{x.placements}, its parameter "
                                 f"{p.placements}")
        return tuple(DTensor.from_local(
            o, p.device_mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride()) for o in local(
                *(x.to_local() for x in (p, g, m, v))))

    def local(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        g = g.to(_wide(g.dtype)) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt_cfg.eps)
        pw = p.to(_wide(p.dtype))
        u = u + opt_cfg.weight_decay * pw
        return (pw - lr * u).to(p.dtype), m, v

    # leaf by leaf, so each leaf's temporaries are freed before the next
    new = tree_map(leaf, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda r: r[i], new)      # noqa: E731
    return pick(0), OptState(pick(1), pick(2), step), \
        {"grad_norm": gnorm, "lr": lr}

"""Train and serve step factories, the twin of :mod:`repro.train.step`.

``make_train_step`` returns a function (params, opt_state, batch) ->
(params, opt_state, metrics); ``make_serve_step`` returns (params,
cache, tokens, positions) -> (logits, cache).  The gradients come from
``torch.autograd.grad`` over the parameter tree's leaves, as the
reference's from ``jax.value_and_grad``.  Under a mesh
(``models.sharding.use_sharding``) the parameters, the optimizer state
and the batch are DTensors laid out by ``param_shardings``,
:func:`opt_shardings` and :func:`batch_shardings` (and a decode cache by
:func:`cache_shardings`), the reference's sharding trees as DTensor
placements; each gradient is redistributed to its parameter's
placements before AdamW, as the reference's ``out_shardings`` lay it
out.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M
from ..models.params import Tree, tree_leaves, tree_map
from ..models.sharding import full, param_sharding, shard
from ..optim.adamw import AdamWConfig, OptState, adamw_update, \
    opt_state_specs

# the logical axes of each input of a train or prefill batch
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "embeds": ("batch", "seq", "embed"),
              "vision_embeds": ("batch", "seq", "embed")}


def _value_and_grad(cfg: ModelConfig, params: Tree, batch: Tree,
                    remat: bool) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn`` on one batch and its gradient, a tree like
    ``params`` (zeros for a leaf the loss does not reach)."""
    flat = [a.detach().requires_grad_() for a in tree_leaves(params)]
    leaves = iter(flat)
    with torch.enable_grad():
        loss = M.loss_fn(cfg, tree_map(lambda _: next(leaves), params),
                         batch, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else _like(g, p)
                  for p, g in zip(flat, grads)])
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` laid out like its parameter ``p``: a DTensor
    gradient that is ``Partial`` (summed over the batch's shards) or
    otherwise placed is redistributed to ``p``'s placements.  It is
    split first (a local chunk where it is whole, a reduce-scatter where
    it is a pending sum) and then summed where a sum is still pending,
    so every sum runs on the parameter's shard, as the reference's
    partitioner reduces a gradient, never on the whole leaf."""
    if not isinstance(g, DTensor) or g.placements == p.placements:
        return g
    mesh, want = p.device_mesh, tuple(p.placements)
    for first in (Replicate, Partial):
        step = tuple(w if isinstance(h, first) and isinstance(w, Shard)
                     else h for h, w in zip(g.placements, want))
        if step != tuple(g.placements):
            g = g.redistribute(mesh, step)
    return g if tuple(g.placements) == want else g.redistribute(mesh, want)


def loss_and_grads(cfg: ModelConfig, params: Tree, batch: Tree,
                   remat: bool = True, microbatch: int = 1
                   ) -> Tuple[torch.Tensor, Tree]:
    """The batch's mean loss and its gradient.  ``microbatch > 1`` splits
    the batch into that many sequential parts, as the reference's
    ``split`` does, adds their losses and gradients into f32 zeros in
    order, then divides by ``microbatch``."""
    if microbatch <= 1:
        return _value_and_grad(cfg, params, batch, remat)
    l_acc = 0.0
    g_acc = tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.promote_types(p.dtype, torch.float32)), params)
    # under a mesh each part is split over the batch's shards like the
    # whole batch (the reshape alone would leave it on one shard)
    split = {k: shard(v.reshape((microbatch, v.shape[0] // microbatch)
                                + v.shape[1:]), None, *BATCH_AXES[k])
             for k, v in batch.items()}
    for i in range(microbatch):
        part = {k: v[i] for k, v in split.items()}
        li, gi = _value_and_grad(cfg, params, part, remat)
        l_acc = l_acc + li
        tree_map(lambda a, g: a.add_(g), g_acc, gi)
        del gi
    return l_acc / microbatch, tree_map(lambda g: g.div_(microbatch), g_acc)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, microbatch: int = 1
                    ) -> Callable[[Tree, OptState, Tree],
                                  Tuple[Tree, OptState,
                                        Dict[str, torch.Tensor]]]:
    """One optimizer step.  ``microbatch > 1`` splits the global batch into
    sequential accumulation steps (the memory knob)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params: Tree, opt: OptState, batch: Tree
             ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
        loss, grads = loss_and_grads(cfg, params, batch, remat, microbatch)
        new_params, new_opt, info = adamw_update(opt_cfg, params, grads, opt)
        info["loss"] = full(loss)
        return new_params, new_opt, info

    return step


def make_serve_step(cfg: ModelConfig):
    def step(params: Tree, cache: Tree, tokens: torch.Tensor,
             positions: torch.Tensor):
        return M.decode_step(cfg, params, cache, tokens, positions)
    return step


# -------------------------------------------------------------- shardings
def batch_shardings(cfg: ModelConfig, shape: ShapeConfig) -> Tree:
    """Placements on the active mesh of every input of
    ``configs.base.input_specs``."""
    def ns(*logical, dims):
        return param_sharding(logical, dims)

    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out: Tree = {}
        if cfg.embed_inputs:
            out["embeds"] = ns(*BATCH_AXES["embeds"],
                               dims=(B, S, cfg.d_model))
        else:
            out["tokens"] = ns(*BATCH_AXES["tokens"], dims=(B, S))
            if cfg.vision_prefix:
                out["vision_embeds"] = ns(*BATCH_AXES["vision_embeds"],
                                          dims=(B, S // 4, cfg.d_model))
        if shape.kind == "train":
            out["labels"] = ns(*BATCH_AXES["labels"], dims=(B, S))
        return out
    return {
        "tokens": ns("batch", None, dims=(B, 1)),
        "positions": ns("batch", dims=(B,)),
    }


def opt_shardings(cfg: ModelConfig) -> OptState:
    """The optimizer state's placements on the active mesh: mu and nu as
    their parameters, the step replicated."""
    specs = opt_state_specs(cfg)
    sh = lambda t: tree_map(                          # noqa: E731
        lambda s: param_sharding(s.axes, s.shape), t)
    return OptState(sh(specs.mu), sh(specs.nu),
                    param_sharding(specs.step.axes, specs.step.shape))


def cache_shardings(cfg: ModelConfig, batch: int, max_seq: int) -> Tree:
    """The decode state's placements on the active mesh."""
    return tree_map(lambda s: param_sharding(s.axes, s.shape),
                    M.cache_specs(cfg, batch, max_seq))

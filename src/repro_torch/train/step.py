"""Train and serve step factories, the twin of :mod:`repro.train.step`.

``make_train_step`` returns a function (params, opt_state, batch) ->
(params, opt_state, metrics); ``make_serve_step`` returns (params,
cache, tokens, positions) -> (logits, cache).  The gradients come from
``torch.autograd.grad`` over the parameter tree's leaves, as the
reference's from ``jax.value_and_grad``.  The reference's sharding
trees (``batch_shardings``, ``opt_shardings``, ``cache_shardings``)
wait for the sharding slice of the port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import model as M
from ..models.params import Tree, tree_leaves, tree_map
from ..optim.adamw import AdamWConfig, OptState, adamw_update


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
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return loss.detach(), tree_map(lambda _: next(grads), params)


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
    g_acc = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
        device=p.device), params)
    for i in range(microbatch):
        part = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                             + v.shape[1:])[i] for k, v in batch.items()}
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
        info["loss"] = loss
        return new_params, new_opt, info

    return step


def make_serve_step(cfg: ModelConfig):
    def step(params: Tree, cache: Tree, tokens: torch.Tensor,
             positions: torch.Tensor):
        return M.decode_step(cfg, params, cache, tokens, positions)
    return step

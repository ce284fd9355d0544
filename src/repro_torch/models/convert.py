"""Carry model weights and optimizer state across packages as plain
values.

The JAX reference's parameter tree, read out as numpy (``jax.tree.map(
np.asarray, params)``), becomes this package's tree of tensors with the
same nested keys and the same bits.  A bf16 leaf reads out as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; its 16-bit
patterns are viewed as ``int16`` and then as ``torch.bfloat16``, so
nothing is rounded on the way.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .params import Tree, tree_map


def _leaf(a: Any, device: torch.device,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a)                 # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Tree, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None) -> Tree:
    """The reference's parameter tree (numpy leaves) as tensors on
    ``device``, in ``dtype`` where given, else in each leaf's own."""
    dev = torch.device(device)
    return tree_map(lambda a: _leaf(a, dev, dtype), tree)


def opt_state_from_jax(state: Any, device: Union[str, torch.device]):
    """The reference's ``OptState`` (numpy leaves, as ``jax.tree.map(
    np.asarray, opt)`` gives) as the port's, on ``device``, bit for
    bit: ``mu`` and ``nu`` trees and the int32 ``step``."""
    from ..optim.adamw import OptState
    dev = torch.device(device)
    return OptState(params_from_jax(state.mu, dev),
                    params_from_jax(state.nu, dev),
                    _leaf(state.step, dev, None))

"""The LM substrate's model, ported: parameter specs and init, the
layers (attention, MLP, MoE, Mamba-1, Mamba-2), forward and the training
loss for every family and decode for every decoder (the twin of
:mod:`repro.models`), the logical-axis sharding on a DeviceMesh
(``sharding``), and the carry functions for the reference's weights
and optimizer state."""
from .convert import opt_state_from_jax, params_from_jax
from .layers import (apply_rope, attention, mamba1, mamba2, mlp, moe,
                     moe_route, rms_norm)
from .model import (abstract_cache, cache_specs, decode_step, forward,
                    init_cache, layer_params, loss_fn)
from .params import (ParamSpec, abstract_params, distribute_params,
                     init_params, param_bytes, param_shardings, param_specs,
                     tree_leaves, tree_map)

__all__ = [
    "ParamSpec", "param_specs", "init_params", "param_bytes", "tree_map",
    "tree_leaves", "params_from_jax", "opt_state_from_jax", "rms_norm",
    "apply_rope", "attention", "mlp", "moe", "moe_route", "mamba1",
    "mamba2", "forward", "loss_fn", "cache_specs", "init_cache",
    "decode_step", "layer_params", "abstract_cache", "abstract_params",
    "distribute_params", "param_shardings",
]

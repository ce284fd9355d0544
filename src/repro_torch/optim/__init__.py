from .adamw import (AdamWConfig, OptState, abstract_opt_state,
                    adamw_update, global_norm, init_opt_state,
                    opt_state_specs)
from .compress import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "OptState", "abstract_opt_state",
           "adamw_update", "global_norm",
           "init_opt_state", "opt_state_specs", "compress_grads",
           "decompress_grads"]

"""Public flash attention: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors or when ``use_kernel=False``."""
from __future__ import annotations

import torch

from .kernel import flash_attention_kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """q (B, Hq, S, d), k/v (B, Hkv, S, d) -> (B, Hq, S, d)."""
    if use_kernel:
        return flash_attention_kernel(q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)

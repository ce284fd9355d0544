"""Public selective scan: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors or when ``use_kernel=False``."""
from __future__ import annotations

import torch

from .kernel import selective_scan_kernel
from .ref import selective_scan_ref


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """x, dt (B,S,Di); A (Di,N); Bm, Cm (B,S,N) -> y (B,S,Di)."""
    if use_kernel:
        return selective_scan_kernel(x, dt, A, Bm, Cm)
    return selective_scan_ref(x, dt, A, Bm, Cm)

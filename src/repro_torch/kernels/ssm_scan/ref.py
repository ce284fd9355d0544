"""Plain PyTorch version of the Mamba-1 selective scan: the oracle of the
CUDA kernel, and what the wrapper runs on CPU tensors.

h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
y_t = h_t @ C_t
"""
from __future__ import annotations

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x, dt (B,S,Di); A (Di,N); Bm, Cm (B,S,N) -> y (B,S,Di)."""
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, Bm, Cm))
    deltaA = torch.exp(dtf[..., None] * Af)               # (B,S,Di,N)
    dBx = (dtf * xf)[..., None] * Bf[:, :, None, :]       # (B,S,Di,N)
    B, S, Di = x.shape
    h = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = deltaA[:, t] * h + dBx[:, t]
        ys[:, t] = torch.einsum("ben,bn->be", h, Cf[:, t])
    return ys.to(x.dtype)

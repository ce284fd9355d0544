"""Plain PyTorch version of the Mamba-1 selective scan: the oracle of the
CUDA kernel, and what the wrapper runs on CPU tensors.

h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
y_t = h_t @ C_t
"""
from __future__ import annotations

from typing import Optional

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



LOG2E = 1.4426950408889634


def selective_scan_runs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, run_len: int,
                        runs_per_chunk: Optional[int] = None) -> torch.Tensor:
    """The CUDA kernel's run decomposition in plain PyTorch, for the tests.

    The sequence is cut into runs of ``run_len`` steps (the last one
    padded with dt = 0, x = 0: decay 1, no input), grouped in chunks of
    ``runs_per_chunk`` runs (default: one chunk of all runs).  In each
    chunk every run is scanned from h = 0 and keeps its decays
    ``2 ** (dt * A log2 e)``; the pairs (product of decays, h) of the
    runs before it are folded in order, carry = P carry + h, starting
    from the chunk's starting state, which gives each run its true carry;
    each run is then replayed from its carry with the decays it kept, and
    the last run's final state starts the next chunk (the kernel: runs of
    8 steps, 4 to a chunk).  x, dt (B,S,Di); A (Di,N); Bm, Cm (B,S,N) ->
    y (B,S,Di)."""
    B, S, Di = x.shape
    R = -(-S // run_len)
    K = runs_per_chunk or R
    pad = -(-R // K) * K * run_len - S

    def runs(t: torch.Tensor) -> torch.Tensor:    # (B, S, ...) -> runs
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B, -1, K, run_len, *t.shape[2:])

    xr, dtr, Br, Cr = runs(x), runs(dt), runs(Bm), runs(Cm)
    start = torch.zeros((B, Di, A.shape[1]), device=x.device)
    ys = []
    for c in range(xr.shape[1]):
        da = torch.exp2(dtr[:, c, ..., None] * (A.float() * LOG2E))
        dbx = (dtr[:, c] * xr[:, c])[..., None] * Br[:, c, :, :, None, :]
        # every run of the chunk from zero, all at once: (B, K, Di, N)
        h, P = dbx[:, :, 0], da[:, :, 0]
        for k in range(1, run_len):
            h = da[:, :, k] * h + dbx[:, :, k]
            P = P * da[:, :, k]
        # each run's carry: the chunk's start folded through the runs before
        carry, carries = start, []
        for r in range(K):
            carries.append(carry)
            carry = P[:, r] * carry + h[:, r]
        # the replay from the true carries
        h = torch.stack(carries, 1)
        for k in range(run_len):
            h = da[:, :, k] * h + dbx[:, :, k]
            ys.append(torch.einsum("brdn,brn->brd", h, Cr[:, c, :, k]))
        start = h[:, -1]
    y = torch.stack(ys, 2)                          # (B, K, T, Di) chunks
    y = y.reshape(B, K, -1, run_len, Di).permute(0, 2, 1, 3, 4)
    return y.reshape(B, -1, Di)[:, :S].to(x.dtype)

"""Operations the plain model references share, in f32.

``Linear`` is every matrix product of a reference.  With ``fp8`` on it is
the control: the product's two inputs rounded to float8 e4m3 (weights
scaled per output column, activations per row), the step below the
configuration's bf16 that a faster program would be tempted to take.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``, returned in f32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class Linear:
    """Matrix products in ``dtype`` (f32; f64 where a test holds the
    reference to the program run in f64), or the fp8 control."""

    def __init__(self, fp8: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        self.fp8, self.dtype = fp8, dtype

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., i) @ w (i, o)``."""
        x, w = x.to(self.dtype), w.to(self.dtype)
        if self.fp8:
            x, w = q8(x, -1), q8(w, -2)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * w.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x (B, T, H, dh)`` at positions 0..T-1, each
    (even, odd) pair rotated by ``pos / theta^(2i / dh)``."""
    T, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=x.dtype,
                                          device=x.device) / dh))
    ang = torch.arange(T, dtype=x.dtype, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def scale_of(dh: int) -> float:
    return 1.0 / math.sqrt(dh)

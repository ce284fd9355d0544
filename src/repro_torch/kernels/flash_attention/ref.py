"""Plain PyTorch version of blocked (flash) attention with GQA and a
causal mask: the oracle of the CUDA kernel, and what the wrapper runs on
CPU tensors."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, d), k/v (B, Hkv, S, d) -> (B, Hq, S, d).

    GQA: Hq must be a multiple of Hkv; query head h reads kv head
    ``h // (Hq // Hkv)``.  Accumulation in fp32.
    """
    B, Hq, S, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, S, d).float()
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg * scale, k.float())
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(B, Hq, S, d).to(q.dtype)

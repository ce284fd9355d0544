"""Plain reference of an attention-free Mamba-1 decoder, as a stream
decodes it: its tuples at positions 0..T-1 from a zero state, computed
from the published configuration's keys (``config.json``) and its
architecture.

Per layer: RMSNorm; the input projection to x and the gate z; the
depthwise causal convolution of x over time (taps ``conv_w``, bias) and
SiLU; the low-rank dt, B and C from x (``FalconMambaForCausalLM``: each
of the three RMS-normed, without a weight, at ``mixer_rms_eps``); dt =
softplus(dt_low W_dt + bias); A = -exp(A_log); the state h_t = exp(dt_t
A) h_{t-1} + dt_t x_t B_t, one step at a time in f32; y_t = h_t C_t + D
x_t, gated by SiLU(z); the output projection and the residual.  All in
f32 from the bf16 weights.  Streams are independent: only the streams
compared are computed, a block at a time.
"""
from __future__ import annotations

import torch

from .common import Linear, rms_norm, silu, softplus

TIME_CHUNK = 16
STREAM_BLOCK = 256
MIXER_NORM = {"FalconMambaForCausalLM"}


def hidden(w: dict, pub: dict, tokens: torch.Tensor, streams: torch.Tensor,
           fp8: bool = False, dtype: torch.dtype = torch.float32):
    """The final normed hidden state (S, T, D) of ``streams`` of
    ``tokens (B, T)``; no routing (None)."""
    parts = [_block(w, pub, tokens[streams[b0:b0 + STREAM_BLOCK]], fp8,
                    dtype) for b0 in range(0, len(streams), STREAM_BLOCK)]
    return torch.cat(parts), None


def _block(w: dict, pub: dict, tokens: torch.Tensor, fp8: bool,
           dtype: torch.dtype) -> torch.Tensor:
    mm = Linear(fp8, dtype)
    L = pub["num_hidden_layers"]
    Di, N = pub["intermediate_size"], pub["state_size"]
    k, R = pub["conv_kernel"], pub["time_step_rank"]
    eps = pub["layer_norm_epsilon"]
    mixer_norm = pub["architectures"][0] in MIXER_NORM
    p = w["blocks"]
    x = w["embed"][tokens].to(dtype)                          # (S, T, D)
    S, T, _ = x.shape
    for l in range(L):
        h = rms_norm(x, p["norm"][l], eps)
        xs, z = mm(h, p["w_in"][l]).split([Di, Di], dim=-1)
        pad = torch.cat([xs.new_zeros((S, k - 1, Di)), xs], dim=1)
        cw = p["conv_w"][l].to(dtype)
        conv = sum(pad[:, i:i + T] * cw[i] for i in range(k))
        xs = silu(conv + p["conv_b"][l].to(dtype))
        dt_low, Bm, Cm = mm(xs, p["w_x"][l]).split([R, N, N], dim=-1)
        if mixer_norm:
            e = pub["mixer_rms_eps"]
            dt_low, Bm, Cm = (rms_norm(t, t.new_ones(t.shape[-1]), e)
                              for t in (dt_low, Bm, Cm))
        dt = softplus(mm(dt_low, p["w_dt"][l]) + p["dt_bias"][l].to(dtype))
        A = -torch.exp(p["A_log"][l].to(dtype))               # (Di, N)
        y = x.new_empty((S, T, Di))
        state = x.new_zeros((S, Di, N))
        for t0 in range(0, T, TIME_CHUNK):
            t1 = min(T, t0 + TIME_CHUNK)
            dA = torch.exp(dt[:, t0:t1, :, None] * A)        # (S, c, Di, N)
            dBx = (dt[:, t0:t1] * xs[:, t0:t1])[..., None] \
                * Bm[:, t0:t1, None, :]
            for t in range(t1 - t0):
                state = torch.addcmul(dBx[:, t], dA[:, t], state)
                y[:, t0 + t] = torch.einsum("sdn,sn->sd", state,
                                            Cm[:, t0 + t])
        y = (y + xs * p["D_skip"][l].to(dtype)) * silu(z)
        x = x + mm(y, p["w_out"][l])
    return rms_norm(x, w["final_norm"], eps)

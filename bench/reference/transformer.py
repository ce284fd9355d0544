"""Plain reference of a decoder with attention, as streams decode it:
each stream's tuples at positions 0..T-1, computed from the published
configuration's keys (``config.json``) and its architecture.

Per layer: RMSNorm; q, k, v; the q/k norm of the architecture
(``Qwen3ForCausalLM``: RMSNorm over each head's width, before the
rotary; ``OlmoeForCausalLM``: RMSNorm over the whole q and k widths);
rotary; causal softmax attention over the positions so far (GQA: each
KV head serves ``heads / kv_heads`` query heads); the output projection
and the residual.  Then RMSNorm and the feed-forward: a SwiGLU, or with
``num_experts`` the router's softmax, the top ``num_experts_per_tok``
experts by a stable descending sort, their probabilities renormalised
only where ``norm_topk_prob`` says so, and every pick's SwiGLU added
with its gate: no expert drops a token.  All in f32 from the bf16
weights.

The rotary turns (even, odd) pairs of a head's width, the layout of the
weights as the harness makes them; ``config.json`` checkpoints turn
(i, i + dh/2) pairs, the same function under a fixed permutation of the
q and k projections' columns, which is how a checkpoint is converted.
Each stream's result depends on its own tuples only: only the streams
compared are computed.
"""
from __future__ import annotations

import torch

from .common import Linear, rms_norm, rope, scale_of, silu

STREAM_BLOCK = 32
QK_NORM = {"Qwen3ForCausalLM": "head", "OlmoeForCausalLM": "full"}


def dims(pub: dict) -> dict:
    """The sizes a reference reads from the published configuration."""
    D, H = pub["hidden_size"], pub["num_attention_heads"]
    return dict(L=pub["num_hidden_layers"], D=D, H=H,
                K=pub.get("num_key_value_heads") or H,
                dh=pub.get("head_dim") or D // H,
                eps=pub["rms_norm_eps"],
                theta=pub.get("rope_theta", 10000.0),
                qk=QK_NORM.get(pub["architectures"][0]))


def hidden(w: dict, pub: dict, tokens: torch.Tensor, streams: torch.Tensor,
           fp8: bool = False, dtype: torch.dtype = torch.float32):
    """The final normed hidden state (S, T, D) of ``streams`` of the token
    array ``tokens (B, T)``, and for a model with experts the number of
    experts that took a token at each position and layer (T, L), else
    None."""
    mm = Linear(fp8, dtype)
    d = dims(pub)
    L, D, H, K, dh, eps = d["L"], d["D"], d["H"], d["K"], d["dh"], d["eps"]
    tokens = tokens[streams]
    S, T = tokens.shape
    blk = w["blocks"]
    a = blk["attn"]
    x = w["embed"][tokens].to(dtype)                      # (S, T, D)
    experts = "moe" in blk
    picked = torch.zeros((T, L), dtype=torch.int64) if experts else None
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for l in range(L):
        h = rms_norm(x, blk["norm1"][l], eps)
        out = x.new_empty((S, T, H * dh))
        for b0 in range(0, S, STREAM_BLOCK):
            hb = h[b0:b0 + STREAM_BLOCK]
            q = mm(hb, a["wq"][l].reshape(D, H * dh))
            k = mm(hb, a["wk"][l].reshape(D, K * dh))
            v = mm(hb, a["wv"][l].reshape(D, K * dh)).reshape(-1, T, K, dh)
            if d["qk"] == "full":
                q = rms_norm(q, q.new_ones(H * dh), eps)
                k = rms_norm(k, k.new_ones(K * dh), eps)
            q, k = q.reshape(-1, T, H, dh), k.reshape(-1, T, K, dh)
            if d["qk"] == "head":
                q = rms_norm(q, a["q_norm"][l], eps)
                k = rms_norm(k, a["k_norm"][l], eps)
            q, k = rope(q, d["theta"]), rope(k, d["theta"])
            k = k.repeat_interleave(H // K, dim=2)
            v = v.repeat_interleave(H // K, dim=2)
            s = torch.einsum("bqhd,bshd->bhqs", q, k) * scale_of(dh)
            s = s.masked_fill(~causal, float("-inf"))
            o = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1), v)
            out[b0:b0 + STREAM_BLOCK] = o.reshape(-1, T, H * dh)
        x = x + mm(out, a["wo"][l])
        h = rms_norm(x, blk["norm2"][l], eps)
        if experts:
            y, picked[:, l] = _moe(mm, blk["moe"], l, h, pub)
        else:
            p = blk["mlp"]
            y = mm(silu(mm(h, p["w_gate"][l])) * mm(h, p["w_up"][l]),
                   p["w_down"][l])
        x = x + y
    return rms_norm(x, w["final_norm"], eps), picked


def _moe(mm, p: dict, l: int, h: torch.Tensor, pub: dict):
    """The experts of layer ``l`` on ``h (S, T, D)``, every pick kept:
    (S, T, D) and the experts a position sent a token to (T,)."""
    S, T, D = h.shape
    E, k = pub["num_experts"], pub["num_experts_per_tok"]
    probs = torch.softmax(mm(h, p["w_router"][l]), dim=-1)     # (S, T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    if pub.get("norm_topk_prob"):
        gates = gates / gates.sum(-1, keepdim=True)
    taken = torch.zeros((T, E), dtype=torch.bool, device=h.device)
    out = torch.zeros_like(h)
    flat = h.reshape(S * T, D)
    acc = out.view(S * T, D)
    for e in range(E):
        rows, picks = (idx == e).reshape(S * T, k).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        taken[rows % T, e] = True
        xe = flat[rows]
        ye = mm(silu(mm(xe, p["w_gate"][l, e])) * mm(xe, p["w_up"][l, e]),
                p["w_down"][l, e])
        g = gates.reshape(S * T, k)[rows, picks]
        acc.index_add_(0, rows, ye * g[:, None])
    return out, taken.sum(-1).cpu()

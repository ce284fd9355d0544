"""The benchmark's yardstick: the card's peaks, the union of device
intervals, the roofline bound, and the least work of a decode step and
of a plan kernel launch, counted from shapes.

``busy_us``, ``bound``, ``table_bytes`` and ``decision_ops`` are frozen
copies of the port's smoke script's arithmetic, so the program can
change without moving the yardstick.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


def busy_us(events: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``[ts, ts + dur)`` over ``events``."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(events):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP64_OPS_PER_S) -> Tuple[float, str]:
    """The least ms for ``bytes_moved`` at the HBM rate and ``ops`` at
    ``ops_per_s``, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(P: int, R: int, H: int, pairs: int, srcs: int, tasks: int,
                real: int = 8, ids: int = 4, flags: int = 1) -> int:
    """Bytes of the instance tables that decisions of ``tasks`` distinct
    tasks read, each distinct row once: the CT row of every (edge, source
    processor) pair, the link-id, valid and hop-count planes of every
    source processor, and the comp and LDET rows of every task."""
    return (pairs * R * H * P * real
            + srcs * (R * H * P * ids + R * P * (flags + ids))
            + tasks * P * (real + real))


def decision_ops(slots: int, P: int, K: int, R: int, H: int) -> int:
    """f64 operations of ``slots`` decisions: per lane, per predecessor
    route hop a max, an add and a running max, per predecessor an arrival
    max, then EST max, EFT add, A/value/B multiplies; per slot the
    commit's add, divide, multiply and add."""
    return slots * (P * (K * (3 * R * H + 1) + 5) + 4)


def step_work(m: dict, streams: int, position: int,
              experts_taken: Optional[Iterable[int]] = None
              ) -> Tuple[float, float, Dict[str, float]]:
    """The least bytes and FLOPs of one decode step of ``streams`` streams
    at ``position``: every weight read once (the embedding only its
    ``streams`` rows; of the experts only those that took a token, per
    layer, ``experts_taken``, else all), the KV rows up to the position
    read and its new row written, the SSM state and conv rows read and
    written, the logits written (f32); 2 FLOPs a weight a token through
    it (an expert's only for its tokens: k per stream), and attention's
    q.k and p.v over the positions so far.  Returns (bytes, flops,
    {part: bytes})."""
    B, D, V, L = streams, m["d_model"], m["vocab"], m["n_layers"]
    w2 = 2                                                  # bf16
    # a tied head reads the whole embedding, its rows with it
    parts: Dict[str, float] = {
        "embed_rows": 0 if m.get("tie_embeddings") else B * D * w2,
        "lm_head": V * D * w2, "logits": B * V * 4}
    flops = 2.0 * V * D * B
    if m["family"] in ("dense", "moe"):
        H, K, F = m["n_heads"], m["n_kv_heads"], m["d_ff"]
        dh = m.get("d_head") or D // H
        attn_w = D * (H + 2 * K) * dh + H * dh * D
        parts["attn_weights"] = L * attn_w * w2
        parts["norms"] = (2 * L + 1) * D * w2 \
            + (2 * L * dh * w2 if m.get("qk_norm") else 0)
        kv_row = 2 * B * K * dh * w2
        parts["kv"] = L * kv_row * (position + 2)
        flops += L * B * (2.0 * attn_w + 4.0 * H * dh * (position + 1))
        if m["family"] == "dense":
            parts["mlp"] = L * 3 * D * F * w2
            flops += L * B * 2.0 * 3 * D * F
        else:
            E, k = m["n_experts"], m["top_k"]
            expert_w = 3 * D * F
            taken = list(experts_taken) if experts_taken is not None \
                else [E] * L
            parts["router"] = L * D * E * w2
            parts["experts"] = sum(taken) * expert_w * w2
            flops += L * B * (2.0 * D * E + 2.0 * k * expert_w)
    elif m["family"] == "ssm":
        Di, N, kc = m.get("expand", 2) * D, m["d_state"], m["d_conv"]
        R = max(1, math.ceil(D / 16))
        mats = D * 2 * Di + Di * (R + 2 * N) + R * Di + Di * D
        vecs = kc * Di + 3 * Di + Di * N + D
        parts["weights"] = L * (mats + vecs) * w2
        parts["state"] = 2 * L * B * Di * N * 4
        parts["conv_rows"] = 2 * L * B * (kc - 1) * Di * w2
        flops += L * B * (2.0 * mats + 9.0 * Di * N + 2.0 * kc * Di)
    else:
        raise ValueError(f"no step work for family {m['family']!r}")
    return float(sum(parts.values())), flops, parts

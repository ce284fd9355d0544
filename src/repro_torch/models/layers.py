"""Model layers in plain PyTorch, the twin of :mod:`repro.models.layers`:
attention, the MLP, the GShard MoE, and the Mamba-1 and Mamba-2 blocks.

The algebra is the reference's, step for step: attention scores and
softmax in f32 with the mask value -1e30, the weights cast to v's dtype
before P·V, ``rms_norm`` through f32 and back, SiLU, the tanh GELU and
softplus written as ``jax.nn`` composes them, so a bf16 activation
rounds where the reference's does.  The MoE routes as ``jax.lax.top_k``
does (ties to the lower expert index) and drops the same overflow; the
Mamba blocks scan in f32 with the reference's chunking.  Functions take
plain dicts of tensors.  Each activation is constrained to its logical
layout (:func:`~repro_torch.models.sharding.shard`) where the
reference constrains it, with the same logical names: a no-op without a
mesh, a DTensor redistribution under one; the constants a layer makes
(positions, masks, aranges) are replicated there.  Attention over whole
sequences, the MoE's routing and experts and Mamba-2's chunked scan run
on each rank's shards (``sharding.local``), where they are local;
attention over whole sequences is :func:`attention_core`, the
reference's ``_sdpa_full`` in chunks of query rows with a backward of
its own that keeps one (Sq, Sk) f32 buffer, as the reference's compiled
step does (:func:`_sdpa_full` and :func:`_sdpa_chunked` stay, the plain
twins of the reference's two functions).  A
cached decode writes its token's k and v into the cache in place,
under a mesh into the shard that owns the position.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..configs.base import ModelConfig
from .sharding import index_copy_, local, pin, replicate, shard, view

Params = Dict[str, torch.Tensor]

# The reference's switch to its query-chunked path (``_sdpa_chunked``,
# kept here as its twin); the model runs ``attention_core`` at every
# length, the same algebra row by row.
ATTN_CHUNK_THRESHOLD = 8192
ATTN_CHUNK = 2048
# Query rows a chunk of the attention core (:func:`attention_core`): 256
# keep a chunk's f32 scores at a sixteenth of its (Sq, Sk) buffer at S
# 4096, so the chunk's temporaries stay a few GB beside it.
ATTN_CORE_ROWS = 256
# mask value of a score that must get no weight
MASKED = -1e30
# MoE dispatch group size + capacity factor (GShard-style), and the
# Mamba scan's chunk (the reference's values)
MOE_GROUP = 256
MOE_CAPACITY_FACTOR = 1.25
SSM_CHUNK = 256
# The stage tap: a callable handed each activation that :func:`tap` is
# given, with its stage's name (the model's embedding; in each layer the
# attention's q, k and v, q and k rotated, each chunk's scores, weights
# and output, and its projected output; the router's probabilities, the
# MoE or MLP and the layer's output; the final norm and the logits), or
# None.  Set only while stage digests are read
# (``repro_torch.launch.oplog.Stages``).
TAP = None
# torch's CPU functions that compute an f32 or f64 tensor with MKL's
# vector math, in chunks of 2048 elements, one a thread (the ones the
# port calls)
VECTOR_MATH = (torch.cos, torch.sin, torch.exp, torch.log, torch.sqrt,
               torch.tanh)


def first_calls_on_one_thread() -> None:
    """Each of ``VECTOR_MATH``'s first call in this process, in f32 and
    f64, on one element, on this thread.  MKL's vector math now and then
    computes one thread's chunk of a process's first call made from
    several threads at once with a lower-accuracy kernel (olmoe's RoPE
    ``cos``: that chunk's values about 7e-9 off relative, where they are
    1e-16 off after; ``tools/vml_first_call.py``).  Run when this module
    is imported, before any model op can make such a call."""
    for dtype in (torch.float32, torch.float64):
        x = torch.ones(1, dtype=dtype)
        for fn in VECTOR_MATH:
            fn(x)


first_calls_on_one_thread()


def tap(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x``, handed to :data:`TAP` as stage ``name`` where one is set."""
    if TAP is not None:
        TAP(name, x)
    return x


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the reference computes in f32; an f64 ``x``
    stays f64, so a model run in f64 (``dtype="float64"``) is exact
    arithmetic throughout, the witness its f32 checks compare with."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = _f32(x)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


# ----------------------------------------------------------------- rotary
def _rope_angles(positions: torch.Tensor, dim: int, theta: float,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2), in ``dtype`` (f32, as
    the reference; f64 in an f64 model)."""
    ar = torch.arange(0, dim, 2, dtype=dtype, device=positions.device)
    freqs = replicate(1.0 / (theta ** (ar / dim)))
    ang = positions.to(dtype)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _apply_rot(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (even, odd) of the last dim; cos/sin (..., d/2)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,dh), k (B,S,K,dh), positions (B,S) integers."""
    dh = cfg.head_dim
    at = torch.promote_types(q.dtype, torch.float32)    # the angles' dtype
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "standard":
        cos, sin = _rope_angles(positions, dh, cfg.rope_theta, at)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)
    if cfg.rope == "partial":
        # chatglm-style 2d RoPE: rotary on the first half of head_dim.
        rd = dh // 2
        cos, sin = _rope_angles(positions, rd, cfg.rope_theta, at)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = torch.cat([_apply_rot(q[..., :rd], cos, sin), q[..., rd:]], -1)
        k = torch.cat([_apply_rot(k[..., :rd], cos, sin), k[..., rd:]], -1)
        return q, k
    if cfg.rope == "mrope":
        # qwen2-vl M-RoPE: head_dim split into (t, h, w) sections with
        # separate position streams (stub: derived from the 1-d position,
        # in integer arithmetic).
        sec = dh // 2 // 4                      # quarters: 2t, 1h, 1w
        pos_t = positions
        pos_h = positions // 64
        pos_w = positions % 64
        cos_t, sin_t = _rope_angles(pos_t, dh, cfg.rope_theta, at)
        cos_h, sin_h = _rope_angles(pos_h, dh, cfg.rope_theta, at)
        cos_w, sin_w = _rope_angles(pos_w, dh, cfg.rope_theta, at)
        idx = replicate(torch.arange(dh // 2, device=positions.device))
        sel_h = (idx >= 2 * sec) & (idx < 3 * sec)
        sel_w = idx >= 3 * sec
        cos = torch.where(sel_h, cos_h, torch.where(sel_w, cos_w, cos_t))
        sin = torch.where(sel_h, sin_h, torch.where(sel_w, sin_w, sin_t))
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)
    raise ValueError(f"unknown rope variant {cfg.rope!r}")


# -------------------------------------------------------------- attention
def _qk_norm(q, k, p, eps):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return q, k


def _weighted_values(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(scores (B,K,G,Sq,Sk), f32) · v (B,Sk,K,dh) -> (B,Sq,K,G,dh),
    the weights cast to v's dtype first."""
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)


def _sdpa_full(q, k, v, causal: bool, q_offset=0) -> torch.Tensor:
    """q (B,Sq,K,G,dh), k/v (B,Sk,K,dh) -> (B,Sq,K,G,dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", _f32(q) * scale, _f32(k))
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, MASKED)
    return _weighted_values(scores, v)


def _sdpa_chunked(q, k, v, causal: bool) -> torch.Tensor:
    """Softmax over query chunks of ATTN_CHUNK rows: O(S*C) score memory
    instead of O(S^2), each chunk exact against all keys."""
    B, S, K, G, dh = q.shape
    C = ATTN_CHUNK
    scale = 1.0 / math.sqrt(dh)
    kf = _f32(k)
    keys = torch.arange(S, device=q.device)
    outs = []
    for i in range(S // C):
        qi = q[:, i * C:(i + 1) * C]
        scores = torch.einsum("bqkgh,bskh->bkgqs", _f32(qi) * scale, kf)
        if causal:
            qpos = i * C + torch.arange(C, device=q.device)
            scores = scores.masked_fill(~(qpos[:, None] >= keys[None, :]),
                                        MASKED)
        outs.append(_weighted_values(scores, v))
    return torch.cat(outs, dim=1)


def _rows_of(x: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows r0:r1 of a (B,S,K,G,dh) tensor as (B·K, G·c, dh): the row
    operand of a batched product over the (batch, KV head) pairs."""
    B, _, K, G, dh = x.shape
    return x[:, r0:r1].permute(0, 2, 3, 1, 4).reshape(B * K, G * (r1 - r0),
                                                     dh)


def _to_rows(y: torch.Tensor, B: int, K: int, G: int) -> torch.Tensor:
    """(B·K, G·c, dh) back to (B,c,K,G,dh)."""
    return y.view(B, K, G, -1, y.shape[-1]).permute(0, 3, 1, 2, 4)


class _Keys:
    """A call's operands that every chunk of query rows shares: k in
    f32 as (B·K, dh, S), v as (B·K, S, dh), and where the attention is
    causal the (S, S) mask of the scores that get no weight."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
        B, S, K, dh = k.shape
        self.kt = _f32(k).permute(0, 2, 3, 1).reshape(B * K, dh, S)
        self.v = v.permute(0, 2, 1, 3).reshape(B * K, S, dh)
        self.masked = None
        if causal:
            pos = torch.arange(S, device=k.device)
            self.masked = pos[:, None] < pos[None, :]
        self.scale = 1.0 / math.sqrt(dh)


def _core_rows(q: torch.Tensor, keys: _Keys, r0: int, r1: int,
               w: torch.Tensor) -> torch.Tensor:
    """Query rows r0:r1 of q (B,S,K,G,dh), as :func:`_sdpa_full`
    computes them: the f32 scores of ``q * scale`` and k, the mask, the
    softmax into ``w`` (B,K,G,c,S), the weights cast to v's dtype times
    v.  Returns the rows' output, (B,c,K,G,dh)."""
    B, _, K, G, _ = q.shape
    rows = tap("attn q rows", _f32(_rows_of(q, r0, r1)) * keys.scale)
    scores = tap("attn scores", torch.bmm(rows, keys.kt).view(w.shape))
    if keys.masked is not None:
        scores.masked_fill_(keys.masked[r0:r1], MASKED)
    torch.ops.aten._softmax.out(scores, -1, False, out=w)
    del scores
    wv = tap("attn weights", w).to(keys.v.dtype).view(B * K, -1,
                                                      w.shape[-1])
    return _to_rows(tap("attn chunk", torch.bmm(wv, keys.v)), B, K, G)


class _AttentionCore(torch.autograd.Function):
    """:func:`_sdpa_full`'s algebra in chunks of ``ATTN_CORE_ROWS`` query
    rows, whose backward holds one (B,K,G,S,S) f32 buffer, the softmax
    weights, as XLA's fused step does; eager autograd of
    :func:`_sdpa_full` holds three at the softmax's backward (the saved
    weights, their gradient and the gradient it makes) and more in
    ``masked_fill``'s backward and the casts.

    The forward writes each chunk's weights into the buffer and saves it
    with q, k and v.  The backward walks the same chunks: v's gradient
    from the weights cast as in the forward; the weights' gradient
    ``dout · vᵀ`` in v's dtype, then in f32 (what autograd of the cast
    computes); the softmax's gradient ``w * (dw - sum(dw * w))``,
    written over the chunk's weights; q's and k's gradients from it.  A
    masked score has weight 0 exactly (``MASKED`` is -1e30), so its
    gradient is 0 with no mask."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        B, S, K, G, _ = q.shape
        buf = torch.empty(B * K * G * S * S, device=q.device,
                          dtype=torch.promote_types(q.dtype, torch.float32))
        out = _core(q, k, v, causal, buf)
        ctx.save_for_backward(q, k, v, buf)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: torch.Tensor):
        q, k, v, buf = ctx.saved_tensors
        B, _, K, G, _ = q.shape
        keys = _Keys(k, v, False)
        acc = keys.kt.dtype
        vt, kf = keys.v.transpose(1, 2), keys.kt.transpose(1, 2)
        dq = torch.empty_like(q)
        dk = torch.zeros(kf.shape, dtype=acc, device=k.device)
        dv = torch.zeros(kf.shape, dtype=acc, device=v.device)
        for r0, r1, w in _core_chunks(buf, q):
            w = w.view(B * K, -1, w.shape[-1])
            do = _rows_of(dout, r0, r1)
            # the weights rounded to v's dtype, their products summed in
            # f32 over every chunk and rounded once, as one product would
            dv += torch.bmm(w.to(v.dtype).to(acc).transpose(1, 2),
                            do.to(acc))
            dw = torch.bmm(do, vt).to(acc)
            dot = (dw * w).sum(dim=-1, keepdim=True)
            w.mul_(dw.sub_(dot))                     # the scores' gradient
            del dw
            dq[:, r0:r1] = _to_rows(torch.bmm(w, kf) * keys.scale,
                                    B, K, G).to(q.dtype)
            dk += torch.bmm(w.transpose(1, 2),
                            _f32(_rows_of(q, r0, r1)) * keys.scale)

        def heads(t, like):
            return t.view(B, K, *t.shape[1:]).permute(0, 2, 1, 3).to(
                like.dtype)

        return dq, heads(dk, k), heads(dv, v), None


def _core_chunks(buf: Optional[torch.Tensor], q: torch.Tensor):
    """(first row, end row, the chunk's (B,K,G,c,S) view of ``buf``) for
    each chunk of ``ATTN_CORE_ROWS`` rows of q (B,S,K,G,dh); ``buf``
    holds them one after another, each chunk contiguous.  With ``buf``
    None each view is a new tensor."""
    B, S, K, G, _ = q.shape
    for r0 in range(0, S, ATTN_CORE_ROWS):
        r1 = min(r0 + ATTN_CORE_ROWS, S)
        shape = (B, K, G, r1 - r0, S)
        w = torch.empty(shape, dtype=torch.promote_types(
            q.dtype, torch.float32), device=q.device) if buf is None \
            else buf[B * K * G * r0 * S:B * K * G * r1 * S].view(shape)
        yield r0, r1, w


def _core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The output, chunk by chunk (:func:`_core_rows`), each chunk's
    weights left in ``buf`` where given (:func:`_core_chunks`)."""
    keys = _Keys(k, v, causal)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for r0, r1, w in _core_chunks(buf, q):
        out[:, r0:r1] = _core_rows(q, keys, r0, r1, w)
    return out


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """Attention over whole sequences, q (B,S,K,G,dh), k/v (B,S,K,dh) ->
    (B,S,K,G,dh): :func:`_sdpa_full`'s values (and :func:`_sdpa_chunked`'s,
    the same algebra row by row).  Where a gradient will be taken
    (:class:`_AttentionCore`) its backward holds one (Sq, Sk) f32 buffer;
    otherwise the rows go chunk by chunk and nothing of (Sq, Sk) size is
    kept: O(S · ``ATTN_CORE_ROWS``) score memory."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionCore.apply(q, k, v, causal)
    return _core(q, k, v, causal)


def _project_heads(x: torch.Tensor, w: torch.Tensor,
                   heads: str) -> torch.Tensor:
    """x (B,S,D) · w (D,H,dh) -> (B,S,H,dh): the one (D, H·dh) product
    ``einsum("bsd,dhk->bshk")`` makes, viewed back to heads by
    :func:`view`.  Under a mesh DTensor may split the flat H·dh product
    where the heads do not divide among the shards; the view lays the
    heads out by their logical axis ``heads`` first, and the weight's
    gradient is pinned to the weight's layout (:func:`pin`) for the same
    reason."""
    D, H, dh = w.shape
    y = torch.einsum("bsd,df->bsf", x, pin(w.reshape(D, H * dh)))
    return view(y, (x.shape[0], x.shape[1], H, dh), "batch", "seq", heads,
                None)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Params] = None,
              cache_pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  Train/prefill: cache is None.  Decode: x is (B,1,D)
    and (cache, cache_pos) carry one layer's KV cache (B, S_max, K, dh)
    and the current positions; the token's k and v are written into the
    cache in place at ``cache_pos[0]`` (positions are uniform across the
    batch, as the reference assumes) and the cache is returned."""
    B, S, D = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    q = _project_heads(x, p["wq"], "heads")
    k = _project_heads(x, p["wk"], "kv_heads")
    v = _project_heads(x, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    q, k = _qk_norm(q, k, p, cfg.norm_eps)
    for name, t in (("q", q), ("k", k), ("v", v)):
        tap(f"attn {name}", t)
    q, k = apply_rope(cfg, q, k, positions)
    tap("attn rope q", q)
    tap("attn rope k", k)
    qg = view(q, (B, S, K, G, dh), "batch", "seq", "kv_heads", None, None)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        idx = cache_pos[:1].long()
        index_copy_(ck, 1, idx, k.to(ck.dtype))
        index_copy_(cv, 1, idx, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv}
        scale = 1.0 / math.sqrt(dh)
        Sk = ck.shape[1]
        # split-K over the cache's positions: each rank scores its own
        # keys; the softmax spans the shards; each rank weighs its own
        # values, and the shards' sums are added
        rows = ("batch", None, None, None)
        keys = ("batch", None, None, None, "cache_seq")
        scores = local(lambda q_, k_: torch.einsum(
            "bqkgh,bskh->bkgqs", _f32(q_) * scale, _f32(k_)),
            ((B, K, G, S, Sk), keys), (qg, rows + (None,)),
            (ck, ("batch", "cache_seq", None, None)))
        mask = replicate(torch.arange(Sk, device=x.device))[None, :] \
            <= cache_pos[:, None]                            # (B, Sk)
        scores = scores.masked_fill(~mask[:, None, None, None, :], MASKED)
        w = torch.softmax(scores, dim=-1)
        out = local(lambda w_, v_: torch.einsum(
            "bkgqs,bskh->bqkgh", w_.to(v_.dtype), v_),
            ((B, S, K, G, dh), rows + (None,)), (w, keys),
            (cv, ("batch", "cache_seq", None, None)),
            partial=("cache_seq", Sk))
    else:
        # whole sequences per rank, the batch and the KV heads split:
        # attention is local to each rank's shards
        heads = ("batch", None, "kv_heads", None)
        out = local(lambda q_, k_, v_: attention_core(q_, k_, v_,
                                                      cfg.causal),
                    (qg.shape, heads + (None,)), (qg, heads + (None,)),
                    (k, heads), (v, heads))

    out = tap("attn core", view(out, (B, S, H * dh), "batch", "seq",
                                "heads"))
    out = torch.einsum("bsh,hd->bsd", out, p["wo"])
    return shard(out, "batch", "seq", "embed"), new_cache


# -------------------------------------------------------------------- mlp
def _as(x: torch.Tensor, c: float) -> float:
    """``c`` rounded to ``x``'s dtype, as JAX rounds a constant it
    combines with an array."""
    return float(torch.tensor(c, dtype=x.dtype))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · logistic(x), the logistic as 1 / (1 + e^-x),
    each operation rounded to x's dtype as XLA evaluates it."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form, its default), operation for operation;
    x³ is x · (x · x), as ``lax.integer_pow`` expands it."""
    inner = x + _as(x, 0.044715) * (x * (x * x))
    cdf = 0.5 * (1.0 + torch.tanh(_as(x, math.sqrt(2 / math.pi)) * inner))
    return x * cdf


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = _silu if cfg.mlp == "swiglu" else _gelu
        h = act(torch.einsum("bsd,df->bsf", x, p["w_gate"])) * \
            torch.einsum("bsd,df->bsf", x, p["w_up"])
    else:
        h = _gelu(torch.einsum("bsd,df->bsf", x, p["w_up"]))
    h = shard(h, "batch", "seq", "ff")
    out = torch.einsum("bsf,fd->bsd", h, p["w_down"])
    return shard(out, "batch", "seq", "embed")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as ``jax.lax`` writes it,
    max(x, 0) + log1p(exp(-|x|)), each operation rounded to x's dtype
    (a NaN input comes out NaN, as there)."""
    return torch.where(torch.isnan(x), x,
                       torch.clamp_min(x, 0) + torch.log1p(
                           torch.exp(-torch.abs(x))))


def _one_hot(idx: torch.Tensor, n: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)``, f32 unless ``dtype`` says otherwise:
    an index outside [0, n) gives a row of zeros (``F.one_hot`` would
    raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# -------------------------------------------------------------------- moe
def _router_probs(cfg: ModelConfig, p: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, int]:
    """The router's probabilities (n, G, E), f32, of x's tokens in groups
    of ``MOE_GROUP``, and the per-expert capacity ``C = top_k * G / E *
    1.25``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = min(MOE_GROUP, B * S)
    C = max(1, int(k * G / E * MOE_CAPACITY_FACTOR))
    logits = torch.einsum("ngd,de->nge", x.reshape(B * S // G, G, D),
                          p["w_router"].to(x.dtype))
    return tap("router", torch.softmax(_f32(logits), dim=-1)), C


def _dispatch(gate_vals: torch.Tensor, gate_idx: torch.Tensor, E: int,
              C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch and combine masks (n, G, E, C), f32, of the picks
    ``gate_idx`` (n, G, k) with their probabilities ``gate_vals``: gates
    are those renormalised; each pick's slot is the exclusive count of
    earlier picks of its expert over the group's picks, token-major and
    slot-minor, and a pick past the capacity is dropped."""
    n, G, k = gate_idx.shape
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    onehot = _one_hot(gate_idx, E, gate_vals.dtype)          # (n,G,k,E)
    flat = onehot.reshape(n, G * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n, G, k, E)
    pos_sel = (pos * onehot).sum(-1)                         # (n,G,k)
    keep = pos_sel < C
    cap_oh = _one_hot(pos_sel.to(torch.int32), C, gate_vals.dtype) \
        * keep[..., None]
    disp = torch.einsum("ngke,ngkc->ngec", onehot, cap_oh)
    comb = torch.einsum("ngke,ngkc->ngec", onehot * gate_vals[..., None],
                        cap_oh)
    return disp, comb


def moe_route(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE's routing: tokens in groups of ``MOE_GROUP``, each group
    dispatching to per-expert capacity ``C`` (:func:`_router_probs`).

    Router logits in x's dtype, softmax in f32, the top k by a stable
    descending sort (ties to the lower index, as ``jax.lax.top_k``), the
    masks by :func:`_dispatch`.  Returns the picked experts (n, G, k)
    and the dispatch and combine masks (n, G, E, C), f32."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = min(MOE_GROUP, B * S)
    n, C = B * S // G, max(1, int(k * G / E * MOE_CAPACITY_FACTOR))
    # each rank routes its own token groups over every expert (the router
    # whole): the routing is local, and a DTensor sort's gradient is not
    rows, masks = ("batch", None, None), ("batch", None, None, None)
    return local(lambda x_, w: _route(cfg, {"w_router": w}, x_),
                 [((n, G, k), rows), ((n, G, E, C), masks),
                  ((n, G, E, C), masks)],
                 (view(x, (n, G, D), *rows), rows),
                 (p["w_router"], (None, None)))


def _route(cfg: ModelConfig, p: Params, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`moe_route` on plain tensors (x (B,S,D) or already in token
    groups (n,G,D))."""
    probs, C = _router_probs(cfg, p, x)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    gate_idx = idx[..., :k]                                  # (n, G, k)
    return (gate_idx, *_dispatch(vals[..., :k], gate_idx, cfg.n_experts, C))


def moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """GShard-style top-k MoE with grouped one-hot dispatch and capacity
    (:func:`moe_route`); overflow tokens drop to the residual path.
    Every expert runs on its whole capacity buffer, as the reference's
    does.  Under a mesh each rank runs its own experts on its own token
    groups (the reference's layout of the dispatched tokens: batch and
    expert split), with the weights' d_model split gathered; the
    combine is a pending sum over the expert shards."""
    B, S, D = x.shape
    _, disp, comb = moe_route(cfg, p, x)
    n, G, E, _ = disp.shape
    rows, groups = ("batch", None, None), ("batch", None, "expert", None)
    ws = [(p[k], ("p_experts", None, None))
          for k in ("w_gate", "w_up", "w_down") if k in p]
    xt = view(x, (n, G, D), *rows)
    out = local(lambda *a: _experts(cfg, *a), ((n, G, D), rows), (xt, rows),
                (disp, groups), (comb, groups), *ws, partial=("expert", E))
    return view(out, (B, S, D), "batch", "seq", "embed")


def _experts(cfg: ModelConfig, xt: torch.Tensor, disp: torch.Tensor,
             comb: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    """The MoE's experts: the tokens xt (n,G,D) dispatched into each
    expert's capacity buffer by ``disp`` (n,G,E,C), each expert's MLP
    (weights ``w_gate``, ``w_up``, ``w_down`` (E, ...), the gate only
    for a gated MLP), and the buffers combined back by ``comb``."""
    xe = torch.einsum("ngd,ngec->necd", xt, disp.to(xt.dtype))
    if cfg.mlp in ("swiglu", "geglu"):
        w_gate, w_up, w_down = ws
        act = _silu if cfg.mlp == "swiglu" else _gelu
        h = act(torch.einsum("necd,edf->necf", xe, w_gate)) * \
            torch.einsum("necd,edf->necf", xe, w_up)
    else:
        w_up, w_down = ws
        h = _gelu(torch.einsum("necd,edf->necf", xe, w_up))
    ye = torch.einsum("necf,efd->necd", h, w_down)
    return torch.einsum("necd,ngec->ngd", ye, comb.to(xt.dtype))


# ------------------------------------------------------------------ mamba
def _ssm_chunk_scan(deltaA: torch.Tensor,
                    deltaBx: torch.Tensor) -> torch.Tensor:
    """Sequential scan over chunks, parallel inside via cumulative
    products: deltaA, deltaBx (B, n_chunks, C, Di, N), f32;
    h_t = deltaA_t * h_{t-1} + deltaBx_t, from h = 0.

    Inside a chunk, h_t = cumA_t * (h_in + sum_{u<=t} bx_u / cumA_u) with
    cumA_t = exp(sum_{u<=t} log deltaA_u), both clamped at 1e-20 where
    the reference clamps them."""
    logA = torch.log(torch.clamp_min(deltaA, 1e-20))
    cumA = torch.exp(torch.cumsum(logA, dim=2))              # (B,nc,C,Di,N)
    acc = torch.cumsum(deltaBx / torch.clamp_min(cumA, 1e-20), dim=2)
    h = torch.zeros_like(deltaA[:, 0, 0])                    # (B,Di,N)
    hs = []
    for c in range(deltaA.shape[1]):
        h_states = cumA[:, c] * (h[:, None] + acc[:, c])     # (B,C,Di,N)
        h = h_states[:, -1]
        hs.append(h_states)
    return torch.stack(hs, dim=1)                            # (B,nc,C,Di,N)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d: x (B,S,Ch), w (k,Ch), the taps added in
    order in x's dtype.  With ``state`` (B,k-1,Ch), the rows before x,
    also the next state: the last k-1 rows of (state, x)."""
    B, S, Ch = x.shape
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((B, k - 1, Ch))
        new_state = None
    else:
        pad = state
        new_state = torch.cat([state, x], dim=1)[:, -(k - 1):]
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(k))
    return out, new_state


def mamba1(cfg: ModelConfig, p: Params, x: torch.Tensor,
           state: Optional[Params] = None,
           ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba-1 selective SSM block (falcon-mamba), chunked scan.

    Decode: x (B,1,D) and ``state = {"h": (B,Di,N) f32, "conv":
    (B,k-1,Di)}``; returns the next state (new tensors)."""
    B, S, D = x.shape
    Di, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
    xz = torch.einsum("bsd,de->bse", x, p["w_in"])           # (B,S,2Di)
    xs, z = torch.split(xz, [Di, Di], dim=-1)
    xs = shard(xs, "batch", "seq", "ssm_inner")
    conv_state = state["conv"] if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xs = _silu(xs + p["conv_b"])

    bcdt = torch.einsum("bse,er->bsr", xs, p["w_x"])         # (B,S,R+2N)
    dt_low, Bss, Css = torch.split(bcdt, [R, N, N], dim=-1)
    dt = _softplus(torch.einsum("bsr,re->bse", dt_low, p["w_dt"])
                   + p["dt_bias"])                           # (B,S,Di)
    A = -torch.exp(_f32(p["A_log"]))                       # (Di,N)

    deltaA = torch.exp(_f32(dt)[..., None] * A)            # (B,S,Di,N)
    dBx = _f32(dt * xs)[..., None] * _f32(Bss)[:, :, None, :]

    if state is not None:
        h = deltaA[:, 0] * state["h"] + dBx[:, 0]            # (B,Di,N)
        y = torch.einsum("ben,bn->be", h, _f32(Css[:, 0]))[:, None]
        new_state = {"h": h, "conv": new_conv}
    else:
        C_chunk = min(SSM_CHUNK, S)
        nc = S // C_chunk
        hs = _ssm_chunk_scan(deltaA.reshape(B, nc, C_chunk, Di, N),
                             dBx.reshape(B, nc, C_chunk, Di, N))
        hs = hs.reshape(B, S, Di, N)
        y = torch.einsum("bsen,bsn->bse", hs, _f32(Css))
        new_state = None

    y = y.to(x.dtype) + xs * p["D_skip"]
    y = y * _silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    return shard(out, "batch", "seq", "embed"), new_state


def _ssd_chunked(dA: torch.Tensor, dt: torch.Tensor, xh: torch.Tensor,
                 Bss: torch.Tensor, Css: torch.Tensor) -> torch.Tensor:
    """Mamba-2's chunked SSD over a whole sequence, in f32: dA (B,S,Hs)
    the log-decays, dt (B,S,Hs), xh (B,S,Hs,dh), Bss and Css (B,S,N);
    returns y (B,S,Hs,dh).  The intra-chunk decay mask L and an
    inter-chunk state recurrence."""
    B, S, Hs, dh = xh.shape
    N = Bss.shape[-1]
    C_chunk = min(SSM_CHUNK, S)
    nc = S // C_chunk
    cum = torch.cumsum(dA.reshape(B, nc, C_chunk, Hs), dim=2)
    xdt = _f32(dt.reshape(B, nc, C_chunk, Hs)[..., None]
               * xh.reshape(B, nc, C_chunk, Hs, dh))
    Bc = _f32(Bss.reshape(B, nc, C_chunk, N))
    Cc = _f32(Css.reshape(B, nc, C_chunk, N))
    # intra-chunk: L[t,u] = exp(cum_t - cum_u) for t >= u
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,C,C,Hs)
    tri = torch.ones(C_chunk, C_chunk, dtype=torch.bool,
                     device=xh.device).tril()
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), device=xh.device))
    scores = torch.einsum("bntk,bnuk->bntu", Cc, Bc)     # (B,nc,C,C)
    # the three-operand contractions pairwise, in opt_einsum's order
    y_intra = torch.einsum("bntuh,bnuhe->bnthe", scores[..., None] * L, xdt)
    # inter-chunk: carry the state across chunks
    seg_end = cum[:, :, -1]                              # (B,nc,Hs)
    chunk_state = torch.einsum(
        "bnuhe,bnuk->bnhek",
        torch.exp(seg_end[:, :, None] - cum)[..., None] * xdt, Bc)
    h = torch.zeros((B, Hs, dh, N), dtype=Bc.dtype, device=xh.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(seg_end[:, c])[..., None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)                      # (B,nc,Hs,dh,N)
    y_inter = torch.einsum(
        "bnthk,bnhek->bnthe",
        Cc[:, :, :, None, :] * torch.exp(cum)[..., None], h_in)
    return (y_intra + y_inter).reshape(B, S, Hs, dh)


def mamba2(cfg: ModelConfig, p: Params, x: torch.Tensor,
           state: Optional[Params] = None,
           ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba-2 (SSD) block with a scalar decay per head (the zamba2
    backbone).  Prefill: chunked SSD, the intra-chunk decay mask L and
    an inter-chunk state recurrence, in f32.  Decode: x (B,1,D) and
    ``state = {"h": (B,Hs,dh,N) f32, "conv": (B,k-1,Di+2N)}``; returns
    the next state (new tensors)."""
    B, S, D = x.shape
    Di, N = cfg.d_inner, cfg.d_state
    Hs, dh = cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, p["w_in"])
    z, xs, Bss, Css, dt_raw = torch.split(zxbcdt, [Di, Di, N, N, Hs],
                                          dim=-1)
    conv_in = torch.cat([xs, Bss, Css], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    conv_out = _silu(conv_out + p["conv_b"])
    xs, Bss, Css = torch.split(conv_out, [Di, N, N], dim=-1)
    xs = shard(xs, "batch", "seq", "ssm_inner")

    dt = _softplus(dt_raw + p["dt_bias"])                    # (B,S,Hs)
    A = -torch.exp(_f32(p["A_log"]))                       # (Hs,)
    dA = _f32(dt) * A                                      # log-decay
    xh = view(xs, (B, S, Hs, dh), "batch", "seq", "ssm_heads", None)

    if state is not None:
        decay = torch.exp(dA[:, 0])                          # (B,Hs)
        # the bf16 outer product rounds to x's dtype, then adds to the
        # f32 state (JAX promotes the sum to f32)
        h = state["h"] * decay[..., None, None] + torch.einsum(
            "bhe,bn->bhen", dt[:, 0, :, None] * xh[:, 0], Bss[:, 0])
        y = torch.einsum("bhen,bn->bhe", h, _f32(Css[:, 0]))
        y = view(y, (B, 1, Di), "batch", "seq", "ssm_inner")
        new_state = {"h": h, "conv": new_conv}
    else:
        # whole sequences per rank, the batch and the SSM heads split: the
        # chunked scan is local to each rank's shards
        heads = ("batch", None, "ssm_heads")
        rows = ("batch", None, None)
        y = local(_ssd_chunked, ((B, S, Hs, dh), heads + (None,)),
                  (dA, heads), (dt, heads), (xh, heads + (None,)),
                  (Bss, rows), (Css, rows))
        y = view(y, (B, S, Di), "batch", "seq", "ssm_inner")
        new_state = None

    y = y.to(x.dtype) + xs * p["D_skip"].repeat_interleave(dh)
    y = rms_norm(y * _silu(z), p["out_norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    return shard(out, "batch", "seq", "embed"), new_state

"""The model: forward and decode for every family, the twin of
:mod:`repro.models.model`: ``dense``, ``vlm`` and ``moe`` (attention and
an MLP or a GShard MoE), the attention-free ``ssm`` (Mamba-1), the
``hybrid`` (groups of Mamba-2 layers, each group followed by one
attention and MLP block whose weights all groups share, with a KV cache
of its own per group) and the encoder-only ``audio``, which has no
decode step; ``loss_fn``, the training loss.

The reference scans a stacked layer axis; here a Python loop walks it,
one layer's views at a time (the hybrid's two axes, group and layer, by
two loops).  A decode step writes the new token's k and v, and each SSM
layer's next state, into the cache in place and returns the same cache
dict.  ``forward(remat=True)`` recomputes each layer's activations in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does; the embedding's gradient is the reference's
custom one (:class:`_EmbedLookup`).  Each stage's activation goes
through ``layers.tap``, which hands it on only where a stage record is
set (a hybrid's group counts as one layer).

Under :func:`~repro_torch.models.sharding.use_sharding` the same code
runs on DTensors: the parameters and the batch are laid out by their
logical axes, and each activation is redistributed (``shard``) where
the reference constrains it, with the same logical names.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .layers import _f32, attention, mamba1, mamba2, mlp, moe, rms_norm, \
    tap
from .params import ParamSpec, tree_map
from .sharding import active, local_shard, placements, replicate, \
    shard, spec_for, use_sharding

Tree = Dict[str, Any]


def _require_decoder(cfg: ModelConfig, what: str) -> None:
    if not cfg.decoder:
        raise ValueError(f"{cfg.name} ({cfg.family}) has no {what}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    """The config's compute dtype: bf16 or f32 as the reference's, or
    f64, the exact-arithmetic witness of the f32 checks."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


def _cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """f32 leaves in ``dtype`` (``.to`` returns a leaf that is already in
    it unchanged); other leaves as they are."""
    return tree_map(
        lambda a: a.to(dtype) if a.dtype == torch.float32 else a, tree)


def layer_params(blocks: Tree, n_layers: int) -> List[Tree]:
    """Each layer's parameters, as views into the stacked ``blocks``."""
    return [tree_map(lambda a, i=i: a[i], blocks) for i in range(n_layers)]


class _EmbedLookup(torch.autograd.Function):
    """The embedding lookup with the reference's custom gradient
    (``_embed_lookup_for``): forward, a row gather; backward, the rows'
    cotangents added into a zero (V, D) table in f32 (f64 in an f64
    model), then cast to the table's dtype.  ``F.embedding``'s backward
    adds them in the table's dtype, which on a bf16 table rounds after
    every repeated token where the reference rounds once.

    Under a mesh the gradient is laid out as the table is (its
    vocabulary split): each rank takes the batch's rows, whole over the
    mesh axes that split the vocabulary, adds those of its own
    vocabulary rows into its (V / shards, D) part of the table, and the
    parts are summed over the axes that split the batch.  That sum is
    one vocabulary shard a rank, as the reference's partitioner reduces
    it; no rank builds the whole table."""

    @staticmethod
    def forward(ctx, table: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        ctx.sharding = active()
        ctx.layout = tuple(table.placements) \
            if isinstance(table, DTensor) else None
        return table.index_select(0, tokens.reshape(-1)).reshape(
            *tokens.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        tokens, = ctx.saved_tensors
        V, D = ctx.table_shape
        acc = torch.promote_types(ctx.table_dtype, torch.float32)
        if not isinstance(g, DTensor):
            return _add_rows(V, D, acc, tokens, g).to(ctx.table_dtype), None
        mesh, vocab = g.device_mesh, ctx.layout
        with use_sharding(ctx.sharding.mesh, ctx.sharding.rules):
            batch = placements(mesh, spec_for(("batch", "seq", None),
                                              g.shape))
        rows = tuple(Replicate() if isinstance(v, Shard) else b
                     for b, v in zip(batch, vocab))
        g = g.redistribute(mesh, rows).to_local()
        tokens = tokens.redistribute(mesh, rows).to_local()
        (n, _), (first, _) = compute_local_shape_and_global_offset(
            (V, D), mesh, vocab)
        # this rank's vocabulary rows; the others' go to a spare row n
        at = tokens - first
        at = torch.where((at >= 0) & (at < n), at, n)
        part = _add_rows(n + 1, D, acc, at, g)[:n]
        dtable = DTensor.from_local(
            part, mesh, [Partial() if isinstance(r, Shard) else v
                         for r, v in zip(rows, vocab)],
            run_check=False, shape=(V, D), stride=(D, 1))
        return dtable.redistribute(mesh, vocab).to(ctx.table_dtype), None


def _add_rows(V: int, D: int, acc: torch.dtype, tokens: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """A zero (V, D) table in ``acc`` with each token's cotangent row
    added into its row."""
    dtable = torch.zeros((V, D), dtype=acc, device=g.device)
    return dtable.index_add_(0, tokens.reshape(-1), g.reshape(-1, D).to(acc))


def _embed_tokens(cfg: ModelConfig, params: Tree,
                  batch: Tree) -> torch.Tensor:
    f = _dtype(cfg)
    if cfg.embed_inputs:
        return shard(batch["embeds"].to(f), "batch", "seq", "embed")
    table = shard(params["embed"], "vocab", None)
    x = _EmbedLookup.apply(table, batch["tokens"].long()).to(f)
    if cfg.vision_prefix and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(f)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return shard(x, "batch", "seq", "embed")


def _dense_block(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                 positions: torch.Tensor, cache=None, cache_pos=None
                 ) -> torch.Tensor:
    """Attention and the feed-forward, each on the normed residual; a
    decode passes the layer's KV cache and the positions it writes.  The
    hybrid's shared block is one too (its params have an ``mlp``)."""
    h, _ = attention(cfg, p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                     positions, cache=cache, cache_pos=cache_pos)
    x = x + tap("attn", h)
    return shard(x + _ffn(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps)),
                 "batch", "seq", "embed")


def _ffn(cfg: ModelConfig, p: Tree, xn: torch.Tensor) -> torch.Tensor:
    """A dense block's feed-forward: its MoE where it has one, else its
    MLP."""
    if "moe" in p:
        return tap("moe", moe(cfg, p["moe"], xn))
    return tap("mlp", mlp(cfg, p["mlp"], xn))


def _ssm_block(cfg: ModelConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    h, _ = mamba1(cfg, p, rms_norm(x, p["norm"], cfg.norm_eps))
    return shard(x + h, "batch", "seq", "embed")


def _mamba2_block(cfg: ModelConfig, p: Tree,
                  x: torch.Tensor) -> torch.Tensor:
    h, _ = mamba2(cfg, p, rms_norm(x, p["norm"], cfg.norm_eps))
    return shard(x + h, "batch", "seq", "embed")


def _groups(cfg: ModelConfig, blocks: Tree) -> List[List[Tree]]:
    """The hybrid's Mamba-2 layers, stacked (G, per, ...): each group's
    layers as views."""
    G = cfg.n_layers // cfg.attn_every
    return [layer_params(tree_map(lambda a, g=g: a[g], blocks),
                         cfg.attn_every) for g in range(G)]


def _logits(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = tap("final_norm", rms_norm(x, params["final_norm"], cfg.norm_eps))
    head = shard(params.get("lm_head", params["embed"]), "vocab", None)
    return tap("logits", shard(_f32(torch.einsum("bsd,vd->bsv", x, head)),
                               "batch", "seq", "vocab"))


def _remat(fn: Callable[..., torch.Tensor],
           remat: bool) -> Callable[..., torch.Tensor]:
    """``fn``, or, with ``remat``, ``fn`` under activation checkpointing:
    only its inputs are kept for the backward pass, which runs it again,
    under the mesh and rules of the forward.  The model draws no random
    numbers, so no RNG state is stashed."""
    if not remat:
        return fn

    def contexts():
        now = active()
        return contextlib.nullcontext(), use_sharding(now.mesh, now.rules)

    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=contexts)


def forward(cfg: ModelConfig, params: Tree, batch: Tree,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V) in f32.  ``remat``
    checkpoints each layer (the hybrid: each Mamba-2 layer, and each
    group with its shared block), which changes memory, not values."""
    params = _cast(params, _dtype(cfg))
    x = tap("embed", _embed_tokens(cfg, params, batch))
    B, S, _ = x.shape
    positions = replicate(torch.arange(S, dtype=torch.int32,
                                       device=x.device).expand(B, S))
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        body = _remat(lambda h, p: _dense_block(cfg, p, h, positions), remat)
        for p in layer_params(params["blocks"], cfg.n_layers):
            x = tap("layer", body(x, p))
    elif cfg.family == "ssm":
        body = _remat(lambda h, p: _ssm_block(cfg, p, h), remat)
        for p in layer_params(params["blocks"], cfg.n_layers):
            x = tap("layer", body(x, p))
    elif cfg.family == "hybrid":
        inner = _remat(lambda h, p: _mamba2_block(cfg, p, h), remat)

        def group_fn(h: torch.Tensor, group: List[Tree]) -> torch.Tensor:
            for p in group:
                h = inner(h, p)
            return _dense_block(cfg, params["shared"], h, positions)

        group_fn = _remat(group_fn, remat)
        for group in _groups(cfg, params["blocks"]):
            x = tap("layer", group_fn(x, group))
    else:
        raise ValueError(cfg.family)
    return _logits(cfg, params, x)


class _TokenNLL(torch.autograd.Function):
    """Each token's ``logsumexp(logits) - logits[label]``, (B, S), with
    the gradient autograd gives ``torch.logsumexp`` and ``gather``, bit
    for bit: ``g * exp(logits - logz)``, less ``g`` at the label.

    The forward is ``torch.logsumexp``'s own algebra: the max (0 where
    it is infinite), the log of the sum of ``exp(logits - max)``, plus
    the max.  Under a mesh the vocabulary axis stays split: the max and
    the sum are reduced across its shards, never gathered, and the gold
    logit comes from the shard that holds it.  The reference takes gold
    by a one-hot contraction for that; a one-hot row has one nonzero
    term, so the gather is the same number, without a second (B, S, V)
    f32 tensor (5 GB at qwen2-0.5b, B 2, S 4096).  The exp runs in place
    in the forward, and the backward writes the gradient over the saved
    logits (the caller must not read them after the backward;
    ``loss_fn``'s are its own): at the train step's peak, which is
    here, the head holds the logits and one more (B, S, V) f32 tensor,
    where it held two more."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        m = shard(logits.amax(-1, keepdim=True), "batch", "seq", None)
        m = m.masked_fill(m.abs() == math.inf, 0)
        # exp in place: one (B, S, V) f32 temporary beside the logits
        total = shard((logits - m).exp_().sum(-1), "batch", "seq")
        logz = torch.log(total) + m[..., 0]
        # a gather from the split vocabulary is summed over its shards
        # before the index axis goes: DTensor cannot reduce it after
        gold = shard(logits.gather(-1, labels[..., None]),
                     "batch", "seq", None)[..., 0]
        ctx.save_for_backward(logits, labels, logz)
        return logz - gold

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        logits, labels, logz = ctx.saved_tensors
        # written over the saved logits, which nothing reads after: the
        # gradient needs no (B, S, V) f32 tensor of its own
        d = logits.sub_(logz[..., None]).exp_().mul_(g[..., None])
        return _sub_at_labels(d, labels, g), None


def _sub_at_labels(d: torch.Tensor, labels: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """``d`` (B, S, V) less ``g`` (B, S) at each token's label, in place:
    ``gather``'s gradient, added as autograd adds it.  Under a mesh each
    rank subtracts where its vocabulary shard holds the label (DTensor
    has no strategy for a scatter into a split axis)."""
    if not isinstance(d, DTensor):
        return d.scatter_add_(-1, labels[..., None], -g[..., None])
    local, offset = local_shard(d, -1)
    rows = [Replicate() if p == Shard(d.ndim - 1) else p
            for p in d.placements]
    labels, g = (t.redistribute(d.device_mesh, rows).to_local()
                 for t in (labels, g))
    at = labels - offset
    own = (at >= 0) & (at < local.shape[-1])
    local.scatter_add_(-1, at.clamp(0, local.shape[-1] - 1)[..., None],
                       torch.where(own, -g, 0.0)[..., None])
    return d


def loss_fn(cfg: ModelConfig, params: Tree, batch: Tree,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy, ``mean(logsumexp(logits) - gold)``
    (:class:`_TokenNLL`)."""
    logits = forward(cfg, params, batch, remat=remat)
    return _TokenNLL.apply(logits, batch["labels"].long()).mean()


# ------------------------------------------------------------------ decode
def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Tree:
    """ParamSpec tree for the decode state: the KV cache, the SSM state
    (f32, or f64 in an f64 model) and the conv rows, as the family needs
    them."""
    _require_decoder(cfg, "decode state")
    B, S = batch, max_seq
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    f = _dtype(cfg)
    hf = torch.promote_types(f, torch.float32)
    Di, N, k = cfg.d_inner, cfg.d_state, cfg.d_conv
    kv_ax = ("layers", "batch", "cache_seq", None, None)
    if cfg.family in ("dense", "vlm", "moe"):
        spec = ParamSpec((L, B, S, K, dh), kv_ax, "zeros", f)
        return {"k": spec, "v": spec}
    if cfg.family == "ssm":
        return {
            "h": ParamSpec((L, B, Di, N),
                           ("layers", "batch", "ssm_inner", None),
                           "zeros", hf),
            "conv": ParamSpec((L, B, k - 1, Di),
                              ("layers", "batch", None, "ssm_inner"),
                              "zeros", f),
        }
    if cfg.family == "hybrid":
        G, per = L // cfg.attn_every, cfg.attn_every
        Hs, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
        kv = ParamSpec((G, B, S, K, dh), kv_ax, "zeros", f)
        return {
            "ssm_h": ParamSpec((G, per, B, Hs, hd, N),
                               ("layers", "layers", "batch", "ssm_heads",
                                None, None), "zeros", hf),
            "ssm_conv": ParamSpec((G, per, B, k - 1, Di + 2 * N),
                                  ("layers", "layers", "batch", None,
                                   "ssm_inner"), "zeros", f),
            "k": kv, "v": kv,
        }
    raise ValueError(f"{cfg.family} has no decode state")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: Union[str, torch.device] = "cuda") -> Tree:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, max_seq))


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> Tree:
    """The decode state as meta tensors (the dry run's)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    cache_specs(cfg, batch, max_seq))


def _ssm_decode(cfg: ModelConfig, layer, p: Tree, x: torch.Tensor,
                h: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """One Mamba layer's decode step from its state ``h`` and ``conv``
    (views into the cache), which are overwritten with the next state."""
    y, st = layer(cfg, p, rms_norm(x, p["norm"], cfg.norm_eps),
                  state={"h": h, "conv": conv})
    h.copy_(st["h"])
    conv.copy_(st["conv"])
    return x + y


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree,
                tokens: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Tree]:
    """One serve step: tokens (B, 1), positions (B,) -> logits (B, 1, V);
    the cache is updated in place and returned."""
    _require_decoder(cfg, "decode step")
    params = _cast(params, _dtype(cfg))
    x = _embed_tokens(cfg, params, {"tokens": tokens})
    pos2d = positions[:, None]
    if cfg.family in ("dense", "vlm", "moe"):
        for i, p in enumerate(layer_params(params["blocks"], cfg.n_layers)):
            x = _dense_block(cfg, p, x, pos2d,
                             cache={"k": cache["k"][i], "v": cache["v"][i]},
                             cache_pos=positions)
    elif cfg.family == "ssm":
        for i, p in enumerate(layer_params(params["blocks"], cfg.n_layers)):
            x = _ssm_decode(cfg, mamba1, p, x, cache["h"][i],
                            cache["conv"][i])
    elif cfg.family == "hybrid":
        for g, group in enumerate(_groups(cfg, params["blocks"])):
            for j, p in enumerate(group):
                x = _ssm_decode(cfg, mamba2, p, x, cache["ssm_h"][g, j],
                                cache["ssm_conv"][g, j])
            x = _dense_block(cfg, params["shared"], x, pos2d,
                             cache={"k": cache["k"][g], "v": cache["v"][g]},
                             cache_pos=positions)
    else:
        raise ValueError(cfg.family)
    return _logits(cfg, params, x), cache

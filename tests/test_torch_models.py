"""The port's model (``repro_torch.models``) against the JAX package's
(``repro.models``) on the same inputs, drawn with numpy from a seed:
each dense layer (the MoE and Mamba layers are in
``tests/test_torch_moe_mamba.py``), the whole forward of every
architecture and the decode step of every decoder, on the reduced
configs (and a hybrid whose groups hold two Mamba-2 layers), with the
reference's weights carried across by ``params_from_jax``.

The reference model runs jitted (its layers under ``lax.scan``), and
XLA by default lets a fusion keep bf16 intermediates in f32
(``xla_allow_excess_precision``): where it fuses, it rounds fewer times
than the reference's code says, and where it fuses depends on the
graph.  The port rounds each bf16 operation as the code writes it, so
it is held against the reference compiled with that option off
(``STRICT``), which rounds as written too.  Measured on the CPU in
bf16: zamba2 and chatglm3 then equal the reference bit for bit, the
other architectures within 0.03-0.21 % relative RMS; against the
default compile, 0.4-1.0 % and for zamba2 3.1 %, under its own bf16
error (6.3 % against f32; this random hybrid is chaotic in bf16), which
``test_forward_against_default_compile`` holds for one architecture of
each family.

Tolerances.  Each layer: ``|got - want| <= tol + tol * |want|`` with
f32 1e-5 and bf16 2e-2 (the reference's own
``tests/test_smoke_archs.py``).  The whole model in f32: the same
elementwise form at 1e-4, because ATen's and XLA's exp, sin, cos and
rsqrt differ by 1-5 ulps and two layers and the head carry that to
3.2e-5 on logits of magnitude 2.  The whole model in bf16: relative RMS
error ``||got - want|| <= 2e-2 * ||want||`` over all the logits, and
over the logits of each (batch, position) row on its own the larger of
2e-2 and the reference's own bf16 error at that row (its bf16 logits
against its f32 ones on the same weights), because one such ulp can
flip a bf16 rounding of an attention output, and the flip cascades
through the later positions (given the same inputs, a bf16 operation
otherwise rounds as the reference's does).  Tokens are compared only in
f32: random-init bf16 logits tie.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro_torch.configs as pcfg
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import params as RP
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import params as PP
from repro_torch.models import params_from_jax

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]
B, S = 2, 16

PORTED = sorted(rcfg.ARCHS)
DECODERS = [n for n in PORTED if rcfg.ARCHS[n].decoder]


# the reference compiled to round every bf16 operation as its code
# writes it (module docstring)
STRICT = {"xla_allow_excess_precision": False}
# a hybrid whose groups hold two Mamba-2 layers each (the reduced
# zamba2 has one a group)
HYBRID_4X2 = dict(n_layers=4, attn_every=2)


def _cfgs(name, dtype="bfloat16", **kw):
    """The reduced config of ``name`` in both packages, in ``dtype``, with
    ``kw`` replaced."""
    r = dataclasses.replace(rcfg.reduced_config(rcfg.get_arch(name)),
                            dtype=dtype, **kw)
    p = dataclasses.replace(pcfg.reduced_config(pcfg.get_arch(name)),
                            dtype=dtype, **kw)
    return r, p


def _strict(fn, *args):
    """``fn`` jitted for ``args`` and compiled with ``STRICT``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def _ref_forward(rc, params, batch):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return _strict(lambda p, b: RM.forward(rc, p, b), params, batch)(
        params, batch)


def _ref_decode(rc, params, batch_size, max_seq):
    """The reference's decode step compiled with ``STRICT``, and its
    empty cache."""
    cache = RM.init_cache(rc, batch_size, max_seq)
    step = _strict(lambda p, c, t, q: RM.decode_step(rc, p, c, t, q),
                   params, cache, jnp.zeros((batch_size, 1), jnp.int32),
                   jnp.zeros((batch_size,), jnp.int32))
    return step, cache


def _pair(a, dtype):
    """One f32 numpy array as a JAX array and a tensor in ``dtype`` (both
    round to nearest even, so the two hold the same bits)."""
    return jnp.asarray(a).astype(JDT[dtype]), \
        torch.from_numpy(np.array(a)).to(TDT[dtype])


def _hold(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def _hold_model(got, want, dtype, want_f32=None):
    """The whole model's tolerance in ``dtype`` (module docstring);
    ``want_f32``: the reference's logits in f32 on the same weights and
    inputs, for the per-position bf16 limit."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    tol = MODEL_TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= tol, rel
    if want_f32 is None:
        return
    # each (batch, position) row of logits on its own
    V = want.shape[-1]
    got, want = got.reshape(-1, V), want.reshape(-1, V)
    want_f32 = np.asarray(want_f32, np.float32).reshape(-1, V)

    def row_rel(a, b):
        return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)

    rows = row_rel(got, want)
    limit = np.maximum(tol, row_rel(want, want_f32))
    assert (rows <= limit).all(), (rows, limit)


def _weights(rc, seed=0):
    """The reference's random weights and their carry into the port."""
    ref = RP.init_params(rc, jax.random.PRNGKey(seed))
    return ref, params_from_jax(jax.tree.map(np.asarray, ref), "cpu")


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(_normal(rng, (B, 5, 64), 3.0), dtype)
    wj, wt = _pair(_normal(rng, (64,)) + 1.0, dtype)
    got = PL.rms_norm(xt, wt, 1e-6)
    assert got.dtype == TDT[dtype]
    _hold(got, RL.rms_norm(xj, wj, 1e-6), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,rope", [("qwen3-8b", "standard"),
                                       ("chatglm3-6b", "partial"),
                                       ("qwen2-vl-7b", "mrope"),
                                       ("hubert-xlarge", "none")])
def test_apply_rope(name, rope, dtype):
    rc, pc = _cfgs(name)
    assert rc.rope == pc.rope == rope
    rng = np.random.default_rng(1)
    H, K, dh = pc.n_heads, pc.n_kv_heads, pc.head_dim
    qj, qt = _pair(_normal(rng, (B, S, H, dh)), dtype)
    kj, kt = _pair(_normal(rng, (B, S, K, dh)), dtype)
    # positions past 64, so mrope's h and w streams are not constant
    pos = (np.arange(S)[None] * 9 + np.array([[3], [130]])).astype(np.int32)
    wq, wk = RL.apply_rope(rc, qj, kj, jnp.asarray(pos))
    gq, gk = PL.apply_rope(pc, qt, kt, torch.from_numpy(pos))
    assert gq.dtype == TDT[str(wq.dtype)] and gk.dtype == TDT[str(wk.dtype)]
    _hold(gq, wq, TOL[dtype])
    _hold(gk, wk, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5),
                                             (False, 0)])
def test_sdpa_full(causal, q_offset, dtype):
    rng = np.random.default_rng(2)
    Sq, Sk, K, G, dh = 7, 12, 2, 3, 16
    qj, qt = _pair(_normal(rng, (B, Sq, K, G, dh)), dtype)
    kj, kt = _pair(_normal(rng, (B, Sk, K, dh)), dtype)
    vj, vt = _pair(_normal(rng, (B, Sk, K, dh)), dtype)
    got = PL._sdpa_full(qt, kt, vt, causal, q_offset)
    want = RL._sdpa_full(qj, kj, vj, causal, q_offset)
    assert got.dtype == TDT[str(want.dtype)]
    _hold(got, want, TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked(causal):
    """The chunked path at S = 2 × ATTN_CHUNK, width 8, in f32."""
    assert PL.ATTN_CHUNK == RL.ATTN_CHUNK
    assert PL.ATTN_CHUNK_THRESHOLD == RL.ATTN_CHUNK_THRESHOLD
    rng = np.random.default_rng(3)
    S2, K, G, dh = 2 * PL.ATTN_CHUNK, 1, 2, 8
    qj, qt = _pair(_normal(rng, (1, S2, K, G, dh)), "float32")
    kj, kt = _pair(_normal(rng, (1, S2, K, dh)), "float32")
    vj, vt = _pair(_normal(rng, (1, S2, K, dh)), "float32")
    _hold(PL._sdpa_chunked(qt, kt, vt, causal),
          RL._sdpa_chunked(qj, kj, vj, causal), TOL["float32"])


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-0.5b", "chatglm3-6b",
                                  "qwen2-vl-7b"])
def test_attention_prefill_and_cached(name, dtype):
    rc, pc = _cfgs(name, dtype)
    ref, _ = _weights(rc)
    pj = RM._cast(_layer0(ref["blocks"]["attn"]), JDT[dtype])
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(4)
    D, K, dh, Smax = pc.d_model, pc.n_kv_heads, pc.head_dim, 12
    # prefill
    xj, xt = _pair(_normal(rng, (B, S, D)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = RL.attention(rc, pj, xj, jnp.asarray(pos))
    got, none = PL.attention(pc, pt, xt, torch.from_numpy(pos.copy()))
    assert none is None
    _hold(got, want, TOL[dtype])
    # one cached decode step at position 5 of a cache filled to 5
    xj, xt = _pair(_normal(rng, (B, 1, D)), dtype)
    ckj, ckt = _pair(_normal(rng, (B, Smax, K, dh)), dtype)
    cvj, cvt = _pair(_normal(rng, (B, Smax, K, dh)), dtype)
    cpos = np.full((B,), 5, np.int32)
    want, wc = RL.attention(rc, pj, xj, jnp.asarray(cpos[:, None]),
                            cache={"k": ckj, "v": cvj},
                            cache_pos=jnp.asarray(cpos))
    got, gc = PL.attention(pc, pt, xt, torch.from_numpy(cpos[:, None]),
                           cache={"k": ckt, "v": cvt},
                           cache_pos=torch.from_numpy(cpos))
    assert gc["k"] is ckt and gc["v"] is cvt        # written in place
    _hold(got, want, TOL[dtype])
    _hold(gc["k"], wc["k"], TOL[dtype])
    _hold(gc["v"], wc["v"], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(kind, dtype):
    rc, pc = _cfgs("qwen3-8b", dtype)
    rc, pc = (dataclasses.replace(c, mlp=kind) for c in (rc, pc))
    ref, _ = _weights(rc)
    pj = RM._cast(_layer0(ref["blocks"]["mlp"]), JDT[dtype])
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    assert ("w_gate" in pt) == (kind != "gelu")
    rng = np.random.default_rng(5)
    xj, xt = _pair(_normal(rng, (B, S, pc.d_model), 2.0), dtype)
    _hold(PL.mlp(pc, pt, xt), RL.mlp(rc, pj, xj), TOL[dtype])


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("name", sorted(rcfg.ARCHS))
def test_param_specs_and_bytes_equal(name):
    """Every family's specs (shapes, logical axes, init rule) at full
    size, and ``param_bytes``, which the cost model reads."""
    rc, pc = rcfg.get_arch(name), pcfg.get_arch(name)
    want = jax.tree.map(lambda s: (s.shape, s.axes, s.init),
                        RP.param_specs(rc), is_leaf=RP._is_spec)
    got = PP.tree_map(lambda s: (s.shape, s.axes, s.init),
                      PP.param_specs(pc))
    assert got == want
    assert PP.param_bytes(pc) == RP.param_bytes(rc)
    if rc.decoder:
        want = jax.tree.map(lambda s: (s.shape, s.axes, jnp.dtype(s.dtype)
                                       .name),
                            RM.cache_specs(rc, 3, 40), is_leaf=RP._is_spec)
        got = PP.tree_map(lambda s: (s.shape, s.axes, str(s.dtype)
                                     .replace("torch.", "")),
                          PM.cache_specs(pc, 3, 40))
        assert got == want


@pytest.mark.parametrize("name", sorted(rcfg.ARCHS))
def test_init_params_follows_the_reference_rules(name):
    """Same tree, shapes and f32 dtype; the constant leaves equal the
    reference's (``a_log`` within the one ulp by which ATen's and XLA's
    log differ); the normal ones have the reference's scale."""
    rc, pc = rcfg.reduced_config(rcfg.get_arch(name)), \
        pcfg.reduced_config(pcfg.get_arch(name))
    ref = jax.tree.map(np.asarray, RP.init_params(rc, jax.random.PRNGKey(0)))
    got = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    specs = PP.param_specs(pc)
    flat_ref, flat_got = jax.tree.leaves(ref), PP.tree_leaves(got)
    assert len(flat_ref) == len(flat_got)
    for s, r, g in zip(PP.tree_leaves(specs), flat_ref, flat_got):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        if s.init == "normal":
            n = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = float(g.std()) * np.sqrt(n)
            assert 0.8 < std < 1.2, (s, std)
        elif s.init == "a_log":
            np.testing.assert_array_max_ulp(g.numpy(), r, maxulp=1)
        else:
            np.testing.assert_array_equal(g.numpy(), r)


def test_init_params_is_seeded():
    pc = pcfg.reduced_config(pcfg.get_arch("qwen3-8b"))
    a, b, c = (PP.init_params(pc, torch.Generator().manual_seed(s), "cpu")
               for s in (7, 7, 8))
    for x, y, z in zip(*(PP.tree_leaves(t) for t in (a, b, c))):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])


def test_params_from_jax_bf16_round_trip_is_bit_exact():
    rc, _ = _cfgs("qwen2-vl-7b")
    ref = RM._cast(RP.init_params(rc, jax.random.PRNGKey(3)), jnp.bfloat16)
    npy = jax.tree.map(np.asarray, ref)
    got = params_from_jax(npy, "cpu")
    for r, g in zip(jax.tree.leaves(npy), PP.tree_leaves(got)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      r.view(np.int16))
    # an explicit dtype converts after the exact carry
    f32 = params_from_jax(npy, "cpu", dtype=torch.float32)
    np.testing.assert_array_equal(f32["embed"].numpy(),
                                  npy["embed"].astype(np.float32))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_params_from_jax_round_trip_every_family(name):
    """The MoE's expert stacks, the Mamba layers' f32-read leaves and the
    hybrid's two-level stack and ``shared`` block carry across bit for
    bit, in bf16 and in f32."""
    rc, _ = _cfgs(name)
    f32 = jax.tree.map(np.asarray, RP.init_params(rc, jax.random.PRNGKey(4)))
    for npy in (f32, jax.tree.map(np.asarray,
                                  RM._cast(f32, jnp.bfloat16))):
        got = params_from_jax(npy, "cpu")
        want_paths = [jax.tree_util.keystr(k) for k, _ in
                      jax.tree_util.tree_leaves_with_path(npy)]
        assert len(want_paths) == len(PP.tree_leaves(got))
        for r, g in zip(jax.tree.leaves(npy), PP.tree_leaves(got)):
            assert tuple(g.shape) == r.shape
            bits = (torch.int16, np.int16) if r.dtype.itemsize == 2 \
                else (torch.int32, np.int32)
            np.testing.assert_array_equal(g.view(bits[0]).numpy(),
                                          r.view(bits[1]))
    if rc.family == "hybrid":
        assert set(got["shared"]) == {"attn", "mlp", "norm1", "norm2"}
        assert got["blocks"]["w_in"].shape[:2] == (
            rc.n_layers // rc.attn_every, rc.attn_every)
    if rc.family == "moe":
        assert got["blocks"]["moe"]["w_up"].shape[:2] == (rc.n_layers,
                                                          rc.n_experts)


# ------------------------------------------------------------ whole model
def _batch(cfg, rng):
    if cfg.embed_inputs:
        return {"embeds": _normal(rng, (B, S, cfg.d_model))}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = _normal(rng, (B, S // 4, cfg.d_model), 0.02)
    return batch


def _f32_forward(name, batch, **kw):
    """The reference's forward in f32 on the same weights and inputs."""
    rc, _ = _cfgs(name, "float32", **kw)
    return _ref_forward(rc, _weights(rc)[0], batch)


def _check_forward(name, dtype, **kw):
    rc, pc = _cfgs(name, dtype, **kw)
    ref, params = _weights(rc)
    batch = _batch(pc, np.random.default_rng(6))
    want = _ref_forward(rc, ref, batch)
    got = PM.forward(pc, params,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (B, S, pc.vocab)
    _hold_model(got, want, dtype, _f32_forward(name, batch, **kw))
    if dtype == "float32" and not pc.embed_inputs:
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want.argmax(-1)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", PORTED)
def test_forward_equals_reference(name, dtype):
    _check_forward(name, dtype)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-vl-7b", "hubert-xlarge",
                                  "olmoe-1b-7b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_forward_against_default_compile(name):
    """One architecture of each family in bf16 against the reference as
    it runs by default (``jax.jit`` with XLA's excess precision on),
    which the tests above replace by ``STRICT``: the port's relative RMS
    error within the reference's own bf16 error (its bf16 logits
    against its f32 ones).  Measured: 0.39-3.05 % against 0.82-6.27 %
    (ratios 0.18-0.68), so a change in that gap shows here."""
    rc, pc = _cfgs(name, "bfloat16")
    ref, params = _weights(rc)
    batch = _batch(pc, np.random.default_rng(6))
    want = np.asarray(jax.jit(lambda p, b: RM.forward(rc, p, b))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()}), np.float32)
    got = PM.forward(pc, params,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    error = _rel(want, np.asarray(_f32_forward(name, batch), np.float32))
    assert _rel(got.numpy(), want) <= error, error


def _check_decode(name, dtype, **kw):
    rc, pc = _cfgs(name, dtype, **kw)
    ref, params = _weights(rc)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, pc.vocab, (B, 6)).astype(np.int32)
    step, rcache = _ref_decode(rc, ref, B, 8)
    pcache = PM.init_cache(pc, B, 8, "cpu")
    # the reference in f32 on the same weights, for the bf16 row limit
    rcf, _ = _cfgs(name, "float32", **kw)
    reff = _weights(rcf)[0]
    step_f32, fcache = _ref_decode(rcf, reff, B, 8)
    for t in range(toks.shape[1]):
        pos = np.full((B,), t, np.int32)
        want, rcache = step(ref, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos))
        want_f32, fcache = step_f32(reff, fcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos))
        got, same = PM.decode_step(pc, params, pcache,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   torch.from_numpy(pos))
        assert same is pcache and got.shape == (B, 1, pc.vocab)
        _hold_model(got, want, dtype, want_f32)
        if dtype == "float32":
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          np.asarray(want.argmax(-1)))
    assert sorted(pcache) == sorted(rcache)
    for k in pcache:
        # the KV cache in the config's dtype, the SSM state in f32 (held
        # at the config's tolerance: in bf16 it sums bf16 inputs)
        assert pcache[k].dtype == TDT[str(rcache[k].dtype)]
        _hold_model(pcache[k], rcache[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DECODERS)
def test_decode_step_equals_reference(name, dtype):
    _check_decode(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_groups_of_two_equal_reference(dtype):
    """zamba2 with two groups of two Mamba-2 layers: the shared block
    runs after each group, with that group's slice of the KV cache."""
    _check_forward("zamba2-2.7b", dtype, **HYBRID_4X2)
    _check_decode("zamba2-2.7b", dtype, **HYBRID_4X2)


def _decode_and_forward(pc, params, toks):
    """The port's logits over ``toks`` (B, S) from S decode steps and
    from one forward."""
    full = PM.forward(pc, params, {"tokens": toks})
    cache = PM.init_cache(pc, toks.shape[0], toks.shape[1], "cpu")
    outs = [PM.decode_step(pc, params, cache, toks[:, t:t + 1],
                           torch.full((toks.shape[0],), t))[0][:, 0]
            for t in range(toks.shape[1])]
    return torch.stack(outs, 1), full


def test_decode_matches_forward_dense():
    """The port's own decode against its forward (the reference's
    ``test_decode_matches_forward_dense``, at its tolerance)."""
    _, pc = _cfgs("qwen3-8b")
    params = PM._cast(PP.init_params(pc, torch.Generator().manual_seed(0),
                                     "cpu"), torch.bfloat16)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, pc.vocab, (B, 8)))
    dec, full = _decode_and_forward(pc, params, toks)
    np.testing.assert_allclose(dec.numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,kw", [("falcon-mamba-7b", {}),
                                     ("zamba2-2.7b", {}),
                                     ("zamba2-2.7b", HYBRID_4X2)],
                         ids=["ssm", "hybrid", "hybrid_4x2"])
def test_decode_matches_forward_ssm_and_hybrid(name, kw):
    """The port's own recurrent decode against its chunked forward in
    f32, at the whole model's 1e-4 (measured: at most 1.5e-6)."""
    _, pc = _cfgs(name, "float32", **kw)
    params = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, pc.vocab, (B, 16)))
    dec, full = _decode_and_forward(pc, params, toks)
    np.testing.assert_allclose(dec.numpy(), full.numpy(),
                               rtol=MODEL_TOL["float32"],
                               atol=MODEL_TOL["float32"])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ref_decode_and_forward(rc, ref, toks):
    """The reference's logits over ``toks`` from decode steps and from one
    forward, both compiled with ``STRICT``."""
    full = np.asarray(_ref_forward(rc, ref, {"tokens": toks}))
    step, cache = _ref_decode(rc, ref, toks.shape[0], toks.shape[1])
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(ref, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.full((toks.shape[0],), t, jnp.int32))
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1), full


@functools.cache
def _smoke():
    """``chip_smoke.py`` as a module, for the limits its card checks
    take from the readings below."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_hybrid_bf16_decode_gap(seed):
    """The reference's own bf16 decode against its bf16 forward, at the
    hybrid with two Mamba-2 layers a group: not small (measured 2.2 %,
    3.2 % and 4.9 % relative RMS for seeds 0-2), but a fraction (0.28,
    0.28, 0.64) of the model's own bf16 error (its bf16 forward against
    its f32 one: 7.9 %, 11.2 %, 7.7 %); 0.57-0.97 at 12 layers in groups
    of 6 and widths 64 and 256.  The card's bound is a multiple of the
    same error, chip_smoke.py's ``HYBRID_BF16_GAP_RATIO``, which the
    port's gap on the CPU meets too."""
    ratio = _smoke().HYBRID_BF16_GAP_RATIO
    out = {}
    for dtype in DTYPES:
        rc, pc = _cfgs("zamba2-2.7b", dtype, **HYBRID_4X2)
        ref = RP.init_params(rc, jax.random.PRNGKey(seed))
        toks = np.random.default_rng(seed).integers(
            0, pc.vocab, (B, S)).astype(np.int32)
        out[dtype] = _ref_decode_and_forward(rc, ref, toks)
        if dtype == "bfloat16":
            port = _decode_and_forward(
                pc, params_from_jax(jax.tree.map(np.asarray, ref), "cpu"),
                torch.from_numpy(toks))
    (dec, full), (_, full_f32) = out["bfloat16"], out["float32"]
    gap, noise = _rel(dec, full), _rel(full, full_f32)
    assert 0.01 < gap <= 0.7 * noise, (gap, noise)
    port_gap = _rel(port[0].numpy(), port[1].numpy())
    assert port_gap <= ratio * noise, (port_gap, noise)


F64_DECODERS = [n for n in DECODERS if rcfg.ARCHS[n].family != "moe"]


@pytest.mark.parametrize("name, kw", [(n, {}) for n in F64_DECODERS]
                         + [("zamba2-2.7b", HYBRID_4X2)],
                         ids=F64_DECODERS + ["zamba2-2.7b-4x2"])
def test_f64_decode_equals_forward(name, kw):
    """In f64 the port's decode equals its forward to rounding (measured
    at most 6.4e-15 on logits up to 2), where in f32 they part by 1e-6
    to 1e-4: the witness that decode_step's layer walk, its cache
    slices and its state updates compute the forward's function.  (The
    MoE's decode differs from its forward by design, below.)"""
    _, pc = _cfgs(name, "float64", **kw)
    params = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, pc.vocab, (B, 16)))
    dec, full = _decode_and_forward(pc, params, toks)
    assert dec.dtype == full.dtype == torch.float64
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-12)


def _port_f64(pc, params):
    """``params`` (f32) in f64 and ``pc`` with dtype f64."""
    return dataclasses.replace(pc, dtype="float64"), \
        PP.tree_map(lambda a: a.double(), params)


def test_f32_gap_ratio_hybrid_full_width():
    """zamba2 at full width (2 layers in 2 groups, so both groups' shared
    blocks and KV slices), f32: the reference's own decode against its
    forward, and the port's, each within chip_smoke.py's
    ``F32_GAP_RATIO`` times the forward's f32 error (against the port's
    f64 forward on the same weights, which equals its f64 decode to
    1e-12).  Measured: the reference's gap 1.10e-5 relative RMS against
    an error of 3.28e-5 (0.34), the port's 3.12e-5 against 2.92e-5
    (1.07); max abs 4.0e-5 and 8.9e-5 on logits up to 1.43."""
    ratio = _smoke().F32_GAP_RATIO
    rc = dataclasses.replace(rcfg.get_arch("zamba2-2.7b"), n_layers=2,
                             attn_every=1, dtype="float32")
    pc = dataclasses.replace(pcfg.get_arch("zamba2-2.7b"), n_layers=2,
                             attn_every=1, dtype="float32")
    ref = RP.init_params(rc, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, pc.vocab,
                                             (B, S)).astype(np.int32)
    rdec, rfull = _ref_decode_and_forward(rc, ref, toks)
    params = params_from_jax(jax.tree.map(np.asarray, ref), "cpu")
    del ref
    tk = torch.from_numpy(toks)
    dec, full = (a.numpy() for a in _decode_and_forward(pc, params, tk))
    d64, f64 = (a.numpy() for a in _decode_and_forward(
        *_port_f64(pc, params), tk))
    np.testing.assert_allclose(d64, f64, rtol=1e-12, atol=1e-12)
    for got, want in ((rdec, rfull), (dec, full)):
        gap, error = _rel(got, want), _rel(want, f64)
        assert gap <= ratio * error, (gap, error)


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_gap_ratio_moe(seed):
    """olmoe (reduced), f32: the port's decode and forward against the
    reference's, with equal routing, within chip_smoke.py's
    ``F32_GAP_RATIO`` times the reference's f32 error (against the
    port's f64 run on the same weights), the card-against-CPU check's
    form.  Measured: 0.75-1.23 of that error (relative RMS 1.3e-6 to
    1.8e-6, max abs 5e-6 to 9.5e-6)."""
    ratio = _smoke().F32_GAP_RATIO
    rc, pc = _cfgs("olmoe-1b-7b", "float32")
    ref, params = _weights(rc, seed)
    toks = np.random.default_rng(seed).integers(0, pc.vocab,
                                                (B, S)).astype(np.int32)
    want = _ref_decode_and_forward(rc, ref, toks)
    tk = torch.from_numpy(toks)
    got = _decode_and_forward(pc, params, tk)
    exact = _decode_and_forward(*_port_f64(pc, params), tk)
    for g, w, e in zip(got, want, exact):
        gap, error = _rel(g.numpy(), w), _rel(w, e.numpy())
        assert gap <= ratio * error, (gap, error)


def test_moe_decode_differs_from_forward_as_the_reference():
    """By the reference's design a decode step's MoE group is the batch
    (B = 2 tokens: capacity 1 of 4 experts) where the forward's is all
    B·S tokens (capacity 20), so other picks overflow and the logits
    differ (measured here: 0.29 max abs on logits up to 1.2, f32).  The
    port's gap equals the reference's within the whole model's f32
    tolerance, and its f32 decode and forward each equal the
    reference's (the tests above)."""
    rc, pc = _cfgs("olmoe-1b-7b", "float32")
    ref, params = _weights(rc)
    toks = np.random.default_rng(8).integers(0, pc.vocab,
                                             (B, S)).astype(np.int32)
    dec, full = _ref_decode_and_forward(rc, ref, toks)
    pdec, pfull = _decode_and_forward(pc, params, torch.from_numpy(toks))
    gap = np.abs(dec - full).max()
    assert gap > 0.05, gap
    np.testing.assert_allclose((pdec - pfull).numpy(), dec - full,
                               rtol=MODEL_TOL["float32"],
                               atol=MODEL_TOL["float32"])


def test_encoder_has_no_decode_step():
    pc = pcfg.reduced_config(pcfg.get_arch("hubert-xlarge"))
    with pytest.raises(ValueError, match="no decode step"):
        PM.decode_step(pc, {}, {}, torch.zeros(B, 1, dtype=torch.long),
                       torch.zeros(B, dtype=torch.long))


def test_entry_points_default_to_the_card():
    """With no device given, the model's entry points run on the card,
    and a host without one refuses rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pc = pcfg.reduced_config(pcfg.get_arch("qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.init_params(pc)

"""The port's model (``repro_torch.models``) against the JAX package's
(``repro.models``) on the same inputs, drawn with numpy from a seed:
each layer, the whole forward of every ``dense`` / ``vlm`` / ``audio``
architecture and the decode step of every ``dense`` / ``vlm`` one, on
the reduced configs, with the reference's weights carried across by
``params_from_jax``.

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
otherwise rounds as the reference's does).  Measured: rows up to 3.2 %
(phi3-mini), each under 0.85x the reference's own bf16 error at that
row where it passes 2 %; elementwise at 2e-2, up to 8.6 % of a row's
logits fall outside, by up to 2.45x.  Tokens are compared only in
f32: random-init bf16 logits tie.
"""
import dataclasses

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

PORTED = sorted(n for n, c in rcfg.ARCHS.items()
                if c.family in ("dense", "vlm", "audio"))
DECODERS = [n for n in PORTED if rcfg.ARCHS[n].family in ("dense", "vlm")]


def _cfgs(name, dtype="bfloat16"):
    """The reduced config of ``name`` in both packages, in ``dtype``."""
    r = dataclasses.replace(rcfg.reduced_config(rcfg.get_arch(name)),
                            dtype=dtype)
    p = dataclasses.replace(pcfg.reduced_config(pcfg.get_arch(name)),
                            dtype=dtype)
    return r, p


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
    if rc.family in ("dense", "vlm"):
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


# ------------------------------------------------------------ whole model
def _batch(cfg, rng):
    if cfg.embed_inputs:
        return {"embeds": _normal(rng, (B, S, cfg.d_model))}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = _normal(rng, (B, S // 4, cfg.d_model), 0.02)
    return batch


def _f32_forward(name, batch):
    """The reference's forward in f32 on the same weights and inputs."""
    rc, _ = _cfgs(name, "float32")
    return RM.forward(rc, _weights(rc)[0],
                      {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", PORTED)
def test_forward_equals_reference(name, dtype):
    rc, pc = _cfgs(name, dtype)
    ref, params = _weights(rc)
    batch = _batch(pc, np.random.default_rng(6))
    want = RM.forward(rc, ref, {k: jnp.asarray(v) for k, v in batch.items()})
    got = PM.forward(pc, params,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (B, S, pc.vocab)
    _hold_model(got, want, dtype, _f32_forward(name, batch))
    if dtype == "float32" and not pc.embed_inputs:
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want.argmax(-1)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DECODERS)
def test_decode_step_equals_reference(name, dtype):
    rc, pc = _cfgs(name, dtype)
    ref, params = _weights(rc)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, pc.vocab, (B, 6)).astype(np.int32)
    rcache = RM.init_cache(rc, B, 8)
    pcache = PM.init_cache(pc, B, 8, "cpu")
    # the reference in f32 on the same weights, for the bf16 row limit
    rcf, _ = _cfgs(name, "float32")
    reff, fcache = _weights(rcf)[0], RM.init_cache(rcf, B, 8)
    for t in range(toks.shape[1]):
        pos = np.full((B,), t, np.int32)
        want, rcache = RM.decode_step(rc, ref, rcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(pos))
        want_f32, fcache = RM.decode_step(rcf, reff, fcache,
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
    for k in ("k", "v"):
        assert pcache[k].dtype == TDT[dtype]
        _hold_model(pcache[k], rcache[k], dtype)


def test_decode_matches_forward_dense():
    """The port's own decode against its forward (the reference's
    ``test_decode_matches_forward_dense``, at its tolerance)."""
    _, pc = _cfgs("qwen3-8b")
    params = PM._cast(PP.init_params(pc, torch.Generator().manual_seed(0),
                                     "cpu"), torch.bfloat16)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, pc.vocab, (B, 8)))
    full = PM.forward(pc, params, {"tokens": toks})
    cache = PM.init_cache(pc, B, 8, "cpu")
    outs = []
    for t in range(8):
        lg, cache = PM.decode_step(pc, params, cache, toks[:, t:t + 1],
                                   torch.full((B,), t))
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", sorted(n for n, c in rcfg.ARCHS.items()
                                        if c.family in ("moe", "ssm",
                                                        "hybrid")))
def test_unported_families_raise(name):
    pc = pcfg.reduced_config(pcfg.get_arch(name))
    params = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PM.forward(pc, params, {"tokens": torch.zeros(B, S,
                                                      dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PM.decode_step(pc, params, {}, torch.zeros(B, 1, dtype=torch.long),
                       torch.zeros(B, dtype=torch.long))


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

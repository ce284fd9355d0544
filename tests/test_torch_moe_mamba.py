"""The port's MoE and Mamba layers (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``) on the same inputs, drawn
with numpy from a seed, with the reference's weights carried across by
``params_from_jax``.

Tolerances: ``|got - want| <= tol + tol * |want|``, f32 1e-5 and bf16
2e-2 (the reference's own ``tests/test_smoke_archs.py``).  The MoE's
routing is held exactly: the activations it dispatches to each expert's
capacity buffer (the reference's ``xe``, read where it passes through
``shard``) must equal the port's bit for bit in f32, including the
picks that tie (``jax.lax.top_k`` breaks ties to the lower index) and
the picks that overflow a capacity of one slot.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import model as RM
from repro.models import params as RP
from repro_torch.models import layers as PL
from repro_torch.models import params_from_jax
from test_torch_models import DTYPES, JDT, TDT, TOL, _cfgs, _hold, _normal, \
    _pair


def _layer(rc, dtype, key, seed=0):
    """One layer of the reference's random weights in ``dtype``, and its
    carry into the port; ``key`` picks the subtree of a dense block."""
    tree = RP.init_params(rc, jax.random.PRNGKey(seed))["blocks"]
    tree = jax.tree.map(lambda a: a[0], tree)
    if rc.family == "hybrid":              # stacked (G, per, ...)
        tree = jax.tree.map(lambda a: a[0], tree)
    if key:
        tree = tree[key]
    pj = RM._cast(tree, JDT[dtype])
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


# -------------------------------------------------------------------- moe
# (name, config overrides, batch, seq): the reduced olmoe (4 experts,
# top 2; one group of 32 tokens, capacity 20), 16 experts top 4 (some
# experts overflow), two groups of 256 tokens, and olmoe's own 64
# experts top 8 on a prefill-sized group (capacity 5) and on a
# decode-sized one (4 tokens, capacity 1)
MOE_CASES = {
    "reduced": ({}, 2, 16),
    "16x4": (dict(n_experts=16, top_k=4), 2, 16),
    "two_groups": ({}, 2, 256),
    "64x8_prefill": (dict(n_experts=64, top_k=8), 2, 16),
    "64x8_decode": (dict(n_experts=64, top_k=8), 4, 1),
    "8x2_decode": (dict(n_experts=8, top_k=2), 4, 1),
}


def _capacity(cfg, tokens):
    G = min(PL.MOE_GROUP, tokens)
    return max(1, int(cfg.top_k * G / cfg.n_experts
                      * PL.MOE_CAPACITY_FACTOR))


def _ref_moe(rc, pj, xj, monkeypatch):
    """The reference's moe and the activations it dispatched (n, E, C, D),
    read where they pass through ``shard`` (a no-op without a mesh)."""
    seen = {}

    def shard(x, *axes):
        seen[axes] = x
        return x

    monkeypatch.setattr(RL, "shard", shard)
    out = RL.moe(rc, pj, xj)
    return out, seen[("batch", "expert", None, None)]


def _port_dispatch(pc, pt, xt):
    """The port's dispatched activations (n, E, C, D) and picks."""
    idx, disp, _ = PL.moe_route(pc, pt, xt)
    n, G = disp.shape[:2]
    xe = torch.einsum("ngd,ngec->necd", xt.reshape(n, G, -1),
                      disp.to(xt.dtype))
    return xe, idx


def _check_moe(rc, pc, pj, pt, x, dtype, monkeypatch):
    xj, xt = _pair(x, dtype)
    want, want_xe = _ref_moe(rc, pj, xj, monkeypatch)
    got = PL.moe(pc, pt, xt)
    assert got.dtype == TDT[dtype] and got.shape == xt.shape
    _hold(got, want, TOL[dtype])
    got_xe, idx = _port_dispatch(pc, pt, xt)
    if dtype == "float32":                 # the routing, exactly
        np.testing.assert_array_equal(got_xe.numpy(), np.asarray(want_xe))
    return got, idx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_equals_reference(case, dtype, monkeypatch):
    kw, b, s = MOE_CASES[case]
    rc, pc = _cfgs("olmoe-1b-7b", dtype, **kw)
    pj, pt = _layer(rc, dtype, "moe")
    x = _normal(np.random.default_rng(10), (b, s, pc.d_model), 2.0)
    got, idx = _check_moe(rc, pc, pj, pt, x, dtype, monkeypatch)
    assert idx.shape[-1] == pc.top_k
    # every token's picks are distinct experts, as top_k's
    assert (idx.sort(-1).values.diff(dim=-1) > 0).all()


def test_moe_capacity_of_one_drops_the_later_picks(monkeypatch):
    """A decode-sized group (4 tokens, 8 experts, top 2): capacity 1, so
    each expert keeps its first pick in token-major, slot-minor order
    and drops the rest; a token whose two picks both overflow gets a
    zero output, in both packages."""
    rc, pc = _cfgs("olmoe-1b-7b", "float32", n_experts=8, top_k=2)
    assert _capacity(pc, 4) == 1
    pj, pt = _layer(rc, "float32", "moe")
    x = _normal(np.random.default_rng(11), (4, 1, pc.d_model), 2.0)
    got, idx = _check_moe(rc, pc, pj, pt, x, "float32", monkeypatch)
    _, disp, comb = PL.moe_route(pc, pt, torch.from_numpy(x))
    picks = idx[0].reshape(-1).tolist()            # token-major
    kept = [e not in picks[:i] for i, e in enumerate(picks)]
    assert not all(kept)                           # something dropped
    held = disp[0].sum(-1)                         # (G, E) 0/1
    for i, (e, k) in enumerate(zip(picks, kept)):
        assert held[i // 2, e] == float(k)
    assert (disp.sum(dim=(1, 3)) <= 1).all()       # one slot an expert
    for t in range(4):
        if not any(kept[2 * t:2 * t + 2]):
            assert (got[t] == 0).all()
            assert (comb[0, t] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("experts,top_k", [(4, 2), (64, 8)])
def test_moe_ties_route_to_the_lower_index(experts, top_k, dtype,
                                           monkeypatch):
    """Router weights zero: every probability is 1/E, so ``jax.lax.top_k``
    routes every token to experts 0..k-1 (``torch.topk`` would not), and
    the first ``C`` tokens fill those experts' capacity."""
    rc, pc = _cfgs("olmoe-1b-7b", dtype, n_experts=experts, top_k=top_k)
    pj, pt = _layer(rc, dtype, "moe")
    pj = dict(pj, w_router=jnp.zeros_like(pj["w_router"]))
    pt = dict(pt, w_router=torch.zeros_like(pt["w_router"]))
    x = _normal(np.random.default_rng(12), (2, 16, pc.d_model), 2.0)
    got, idx = _check_moe(rc, pc, pj, pt, x, dtype, monkeypatch)
    assert (idx == torch.arange(top_k)).all()
    # the first C tokens (batch-major) fill experts 0..k-1; the rest
    # overflow every pick and get a zero output
    C = _capacity(pc, 32)
    flat = got.reshape(32, -1)
    assert C < 32 and (flat[C:] == 0).all()
    assert (flat[:C] != 0).any(dim=-1).all()


# ------------------------------------------------------------------ mamba
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state, dtype):
    rng = np.random.default_rng(20)
    Bt, St, Ch, k = 2, 9, 24, 4
    xj, xt = _pair(_normal(rng, (Bt, St, Ch)), dtype)
    wj, wt = _pair(_normal(rng, (k, Ch), 0.5), dtype)
    sj, st = _pair(_normal(rng, (Bt, k - 1, Ch)), dtype) if with_state \
        else (None, None)
    want, want_state = RL._causal_conv(xj, wj, sj)
    got, got_state = PL._causal_conv(xt, wt, st)
    assert got.dtype == TDT[dtype]
    _hold(got, want, TOL[dtype])
    if with_state:
        _hold(got_state, want_state, 0.0)
    else:
        assert got_state is None and want_state is None


def test_causal_conv_state_of_one_token():
    """Decode: one row in, the state shifts by one row."""
    rng = np.random.default_rng(21)
    xj, xt = _pair(_normal(rng, (3, 1, 8)), "bfloat16")
    wj, wt = _pair(_normal(rng, (4, 8)), "bfloat16")
    sj, st = _pair(_normal(rng, (3, 3, 8)), "bfloat16")
    want, want_state = RL._causal_conv(xj, wj, sj)
    got, got_state = PL._causal_conv(xt, wt, st)
    _hold(got, want, TOL["bfloat16"])
    assert torch.equal(got_state, torch.cat([st[:, 1:], xt], 1))
    _hold(got_state, want_state, 0.0)


@pytest.mark.parametrize("chunks", [1, 2])
def test_ssm_chunk_scan(chunks):
    """Two chunks of 256 steps carry the state across the boundary;
    decays and inputs as a Mamba layer makes them (f32), small enough
    that no prefix product of a chunk falls under the 1e-20 clamp, so
    the plain recurrence holds too."""
    rng = np.random.default_rng(22)
    Bt, C, Di, N = 2, 256, 6, 4
    dt = rng.uniform(1e-3, 0.02, (Bt, chunks, C, Di, 1))
    A = np.arange(1, N + 1)
    dA = np.exp(-dt * A).astype(np.float32)
    dBx = _normal(rng, (Bt, chunks, C, Di, N), 0.1)
    want = RL._ssm_chunk_scan(jnp.asarray(dA), jnp.asarray(dBx))
    got = PL._ssm_chunk_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    assert got.dtype == torch.float32 and got.shape == dA.shape
    _hold(got, want, TOL["float32"])
    # the plain recurrence, on the same inputs
    h = np.zeros((Bt, Di, N), np.float64)
    flat_a, flat_b = dA.reshape(Bt, -1, Di, N), dBx.reshape(Bt, -1, Di, N)
    for t in range(chunks * C):
        h = flat_a[:, t] * h + flat_b[:, t]
    np.testing.assert_allclose(got.reshape(Bt, -1, Di, N)[:, -1].numpy(),
                               h, rtol=1e-4, atol=1e-4)


def _ssm_case(name, dtype):
    rc, pc = _cfgs(name, dtype)
    pj, pt = _layer(rc, dtype, None)
    return rc, pc, pj, pt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,fn,S", [("falcon-mamba-7b", "mamba1", 16),
                                       ("falcon-mamba-7b", "mamba1", 512),
                                       ("zamba2-2.7b", "mamba2", 16),
                                       ("zamba2-2.7b", "mamba2", 512)])
def test_mamba_prefill(name, fn, S, dtype):
    """The prefill at one chunk and at two (S = 512, the state carried
    across chunks of 256)."""
    rc, pc, pj, pt = _ssm_case(name, dtype)
    xj, xt = _pair(_normal(np.random.default_rng(23), (2, S, pc.d_model)),
                   dtype)
    want, wnone = getattr(RL, fn)(rc, pj, xj)
    got, gnone = getattr(PL, fn)(pc, pt, xt)
    assert gnone is None and wnone is None
    assert got.dtype == TDT[dtype]
    assert np.isfinite(np.asarray(jnp.asarray(want, jnp.float32))).all()
    _hold(got, want, TOL[dtype])


def test_mamba_prefill_chunk_must_divide():
    """S = 300 is not a multiple of the 256-step chunk: the reference's
    reshape fails, and so does the port's (no padding)."""
    rc, pc, pj, pt = _ssm_case("falcon-mamba-7b", "float32")
    x = _normal(np.random.default_rng(24), (1, 300, pc.d_model))
    with pytest.raises(TypeError):
        RL.mamba1(rc, pj, jnp.asarray(x))
    with pytest.raises(RuntimeError):
        PL.mamba1(pc, pt, torch.from_numpy(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,fn", [("falcon-mamba-7b", "mamba1"),
                                     ("zamba2-2.7b", "mamba2")])
def test_mamba_decode(name, fn, dtype):
    """One decode step from a random state: the output and the next SSM
    state (f32) and conv rows."""
    rc, pc, pj, pt = _ssm_case(name, dtype)
    rng = np.random.default_rng(25)
    Bt, k = 3, pc.d_conv
    if fn == "mamba1":
        hshape = (Bt, pc.d_inner, pc.d_state)
        conv_ch = pc.d_inner
    else:
        hshape = (Bt, pc.n_ssm_heads, pc.ssm_head_dim, pc.d_state)
        conv_ch = pc.d_inner + 2 * pc.d_state
    hj, ht = _pair(_normal(rng, hshape), "float32")
    cj, ct = _pair(_normal(rng, (Bt, k - 1, conv_ch)), dtype)
    xj, xt = _pair(_normal(rng, (Bt, 1, pc.d_model)), dtype)
    want, wst = getattr(RL, fn)(rc, pj, xj, state={"h": hj, "conv": cj})
    got, gst = getattr(PL, fn)(pc, pt, xt, state={"h": ht, "conv": ct})
    assert got.dtype == TDT[dtype] and gst["h"].dtype == torch.float32
    assert gst["conv"].dtype == TDT[dtype]
    _hold(got, want, TOL[dtype])
    _hold(gst["h"], wst["h"], TOL[dtype])
    _hold(gst["conv"], wst["conv"], 0.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_softplus(dtype):
    """``jax.nn.softplus`` op for op, across the range where log1p(exp)
    and the max branch trade places."""
    x = np.concatenate([np.linspace(-30, 30, 601, dtype=np.float32),
                        np.array([0.0, -0.0, 1e-8, 88.0], np.float32)])
    xj, xt = _pair(x, dtype)
    got = PL._softplus(xt)
    assert got.dtype == TDT[dtype]
    _hold(got, jax.nn.softplus(xj), TOL[dtype] / 2)
    assert torch.isnan(PL._softplus(torch.tensor([float("nan")]))).all()

"""The port's training path (``repro_torch.{data,optim,train,checkpoint}``,
``models.model.loss_fn`` and ``launch.train``) against the JAX package's
on the same inputs: weights carried across by ``params_from_jax``,
batches from the numpy pipeline (its seed), on the reduced configs.
The reference runs jitted; where bf16 is compared it is compiled with
``STRICT`` (``tests/test_torch_models.py`` says why).

Tolerances.  ``loss_fn`` in f32: the loss at 1e-5 relative; each
gradient leaf by relative RMS, ``||got - want|| <= limit * ||want||``,
at 1e-4, or at ``F32_GAP_RATIO`` (chip_smoke.py, 3) times the
reference's own f32 error on that leaf (its f32 gradient against the
port's f64 one, the exact witness) where that is larger: some leaves'
f32 gradients are themselves good to only ~1e-4 (measured: zamba2's
``A_log``, 1.39e-4 for the port and 5.8e-5 for the reference against
the f64 gradient, and 1.14e-4 between the two; every other leaf of
every architecture reads 3.1e-5 or less).  The witness comes from the
port, so it is first held to the reference itself, at ``WITNESS_CAP``
(1e-4; measured at most 5.8e-5, zamba2's ``A_log``): a fault in the
port's backward would be in its f64 gradient too and would otherwise
widen its own limit.  The limit is then at most 3e-4.  In bf16: the
loss at 2e-2 relative, each leaf at the larger of 2e-2 and the
reference's own bf16 error on it (its bf16 gradient against its f32
one; measured 0.012 to 0.49, the port's gap 0.005 to 0.015).  The
optimizer is held elementwise at 1e-6 relative, the compressor exactly
(codes, scales) and at 1e-7 (residual), the data and the checkpoints
bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro_torch.configs as pcfg
from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.configs.base import ShapeConfig as RShape
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticTokenPipeline as RPipe
from repro.models import model as RM
from repro.models import params as RP
from repro.optim import adamw as RA
from repro.optim import compress_grads as ref_compress
from repro.optim import decompress_grads as ref_decompress
from repro.train import make_train_step as ref_train_step
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train as LT
from repro_torch.models import model as PM
from repro_torch.models import opt_state_from_jax, params_from_jax
from repro_torch.models import params as PP
from repro_torch.optim import adamw as PA
from repro_torch.optim import compress_grads, decompress_grads
from repro_torch.train import loss_and_grads, make_serve_step, \
    make_train_step
from test_torch_models import _cfgs, _smoke, _strict

ARCHS = sorted(rcfg.ARCHS)
DTYPES = ["float32", "bfloat16"]
B, S = 2, 16
# the most the port's f64 result may part from the reference's f32 one
# where it serves as the exact witness of a limit: a gradient leaf, and
# a parameter after three train steps (measured at most 5.8e-5 and
# 1.71e-4: zamba2's A_log, and qwen2's bk at microbatch 1)
WITNESS_CAP = {"grads": 1e-4, "train_step": 2.5e-4}


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _rel(got, want):
    """Relative RMS error; a leaf that is zero (hubert's embedding table,
    which its embedding inputs never read) must come out zero."""
    got, want = _np(got), _np(want)
    norm = np.linalg.norm(want)
    if norm == 0:
        return 0.0 if not got.any() else float("inf")
    return float(np.linalg.norm(got - want) / norm)


def _weights(rc, seed=0):
    ref = RP.init_params(rc, jax.random.PRNGKey(seed))
    return ref, params_from_jax(jax.tree.map(np.asarray, ref), "cpu")


def _batch(cfg, step=0, seq=S, batch=B):
    """The reference pipeline's numpy batch (the port's draws the same
    bits, ``test_batch_for_step_bit_for_bit``)."""
    return RPipe(cfg, RShape("t", seq, batch, "train")).batch_for_step(step)


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _ref_loss_and_grads(rc, ref, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = _strict(jax.value_and_grad(lambda p, b: RM.loss_fn(rc, p, b)),
                 ref, jb)
    loss, grads = fn(ref, jb)
    return float(loss), jax.tree.leaves(grads)


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_leaves_with_path(tree)]


# ------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_equal_reference(name, dtype):
    rc, pc = _cfgs(name, dtype)
    ref, params = _weights(rc)
    batch = _batch(pc)
    want_loss, want = _ref_loss_and_grads(rc, ref, batch)
    loss, grads = loss_and_grads(pc, params, _torch(batch))
    got = PP.tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert bool(torch.isfinite(g).all())
    keys = _paths(ref)
    if dtype == "float32":
        assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
        _, pf64 = _cfgs(name, "float64")
        _, exact = loss_and_grads(
            pf64, PP.tree_map(lambda a: a.double(), params), _torch(batch))
        ratio = _smoke().F32_GAP_RATIO
        for key, g, w, e in zip(keys, got, want, PP.tree_leaves(exact)):
            own = _rel(w, e)
            assert own <= WITNESS_CAP["grads"], (key, "witness", own)
            limit = max(1e-4, ratio * own)
            assert _rel(g, w) <= limit, (key, _rel(g, w), limit)
        return
    assert abs(float(loss) - want_loss) <= 2e-2 * abs(want_loss)
    rf, _ = _cfgs(name, "float32")
    _, want_f32 = _ref_loss_and_grads(rf, _weights(rf)[0], batch)
    for key, g, w, w32 in zip(keys, got, want, want_f32):
        limit = max(2e-2, _rel(w, w32))
        assert _rel(g, w) <= limit, (key, _rel(g, w), limit)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_remat_changes_no_value(name):
    """``forward(remat=True)`` recomputes each layer in the backward pass
    (the hybrid: each Mamba-2 layer and each group): the loss and every
    gradient equal the run that keeps the activations, bit for bit."""
    _, pc = _cfgs(name, "float32", **(
        dict(n_layers=4, attn_every=2) if name == "zamba2-2.7b" else {}))
    params = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    batch = _torch(_batch(pc))
    l0, g0 = loss_and_grads(pc, params, batch, remat=False)
    l1, g1 = loss_and_grads(pc, params, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(PP.tree_leaves(g0), PP.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_loss_gathers_the_one_hot_contraction():
    """The gold logit by ``gather`` equals the reference's one-hot
    contraction bit for bit (one nonzero term)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 8, 97)).astype(np.float32) * 4
    labels = rng.integers(0, 97, (2, 8)).astype(np.int32)
    want = jnp.einsum("bsv,bsv->bs", logits,
                      jax.nn.one_hot(labels, 97, dtype=jnp.float32))
    got = torch.from_numpy(logits).gather(
        -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_lookup_grad_equals_reference_custom_vjp(dtype):
    """``_EmbedLookup``'s gradient against the reference's custom VJP on
    a batch of 512 tokens drawn from 6 (each repeated ~85 times): the
    rows of the f32 sum, cast to the table's dtype, bit for bit.  In bf16
    ``F.embedding``'s backward, which adds in the table's dtype, misses
    them (the reason for the custom gradient)."""
    V, D = 64, 32
    rng = np.random.default_rng(5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    table = jnp.asarray(rng.standard_normal((V, D)), jnp.float32).astype(jdt)
    tokens = rng.choice([1, 5, 9, 17, 33, 62], size=(4, 128)).astype(np.int32)
    g = jnp.asarray(rng.standard_normal((4, 128, D)), jnp.float32).astype(jdt)
    out, vjp = jax.vjp(lambda t: RM._embed_lookup(t, jnp.asarray(tokens)),
                       table)
    want = np.asarray(vjp(g)[0].astype(jnp.float32))
    t = params_from_jax({"t": np.asarray(table)}, "cpu")["t"]
    t.requires_grad_()
    gt = params_from_jax({"g": np.asarray(g)}, "cpu")["g"]
    tok = torch.from_numpy(tokens).long()
    got_out = PM._EmbedLookup.apply(t, tok)
    np.testing.assert_array_equal(got_out.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    got, = torch.autograd.grad(got_out, t, gt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16":
        naive, = torch.autograd.grad(torch.nn.functional.embedding(tok, t),
                                     t, gt)
        assert not np.array_equal(naive.float().numpy(), want)


# ----------------------------------------------------------- optimizer
def _opt_case(seed, step, grad_scale):
    """Reference params (reduced qwen2-0.5b) with random gradients and a
    random state at ``step``, as numpy."""
    rc, _ = _cfgs("qwen2-0.5b", "float32")
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, RP.init_params(
        rc, jax.random.PRNGKey(seed)))
    like = lambda s=1.0: jax.tree.map(  # noqa: E731
        lambda a: (rng.standard_normal(a.shape) * s).astype(np.float32),
        params)
    grads = like(grad_scale)
    mu = like(1e-2)
    nu = jax.tree.map(lambda a: a * a, like(1e-1))
    return params, grads, RA.OptState(mu, nu, np.asarray(step, np.int32))


OPT_CASES = {"warmup": (0, 0, 1.0), "warmup_late": (1, 57, 1.0),
             "cosine": (2, 150, 1.0), "after_total": (3, 12000, 1.0),
             "unclipped": (4, 150, 1e-4)}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_equals_reference(case):
    seed, step, scale = OPT_CASES[case]
    params, grads, state = _opt_case(seed, step, scale)
    cfg = dict(warmup_steps=100, total_steps=10000)
    want_p, want_s, want_i = RA.adamw_update(
        RA.AdamWConfig(**cfg), params, grads,
        RA.OptState(*jax.tree.map(jnp.asarray, tuple(state))))
    got_p, got_s, got_i = PA.adamw_update(
        PA.AdamWConfig(**cfg), params_from_jax(params, "cpu"),
        params_from_jax(grads, "cpu"), opt_state_from_jax(state, "cpu"))
    # each new value at 1e-6 of the terms it sums (mu = b1 m + (1 - b1) g
    # cancels where m and g have opposite signs; p - lr u where p and
    # lr u nearly cancel); the clipped g's scale differs from the
    # reference's by the global norm's last bits
    clip = min(1.0, 1.0 / (float(want_i["grad_norm"]) + 1e-9))
    for g, w, terms in (
            (got_s.mu, want_s.mu, jax.tree.map(
                lambda m, d: 0.9 * np.abs(m) + 0.1 * clip * np.abs(d),
                state.mu, grads)),
            (got_s.nu, want_s.nu, want_s.nu),
            (got_p, want_p, jax.tree.map(
                lambda w, p: np.maximum(np.abs(w), np.abs(w - p)),
                jax.tree.map(np.asarray, want_p), params))):
        for a, b, t in zip(PP.tree_leaves(g), jax.tree.leaves(w),
                           jax.tree.leaves(terms)):
            assert a.dtype == torch.float32
            assert (np.abs(a.numpy() - np.asarray(b))
                    <= 1e-6 * np.abs(np.asarray(t))).all()
    assert got_s.step.dtype == torch.int32
    assert int(got_s.step) == int(want_s.step) == step + 1
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got_i[k]), float(want_i[k]),
                                   rtol=1e-6)
    # clipping engaged in every case but the small-gradient one
    assert (float(got_i["grad_norm"]) > 1.0) == (case != "unclipped")


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999,
                                  10000, 20000])
def test_schedule_equals_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10000)
    want = RA._schedule(RA.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    got = PA._schedule(PA.AdamWConfig(**cfg),
                       torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def test_init_opt_state_and_specs_equal_reference():
    rc, pc = _cfgs("zamba2-2.7b", "float32")
    ref, params = _weights(rc)
    want = RA.init_opt_state(ref)
    got = PA.init_opt_state(params)
    for g, w in zip(PP.tree_leaves(got.mu) + PP.tree_leaves(got.nu),
                    jax.tree.leaves(want.mu) + jax.tree.leaves(want.nu)):
        assert g.dtype == torch.float32 and not bool(g.any())
        assert tuple(g.shape) == w.shape
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    # mu and nu are separate tensors
    assert got.mu["embed"].data_ptr() != got.nu["embed"].data_ptr()
    ws = RA.opt_state_specs(rc)
    gs = PA.opt_state_specs(pc)
    flat = lambda t: [(s.shape, s.axes) for s in jax.tree.leaves(  # noqa
        t, is_leaf=RP._is_spec)]
    assert [(s.shape, s.axes) for s in PP.tree_leaves(gs.mu)] == \
        flat(ws.mu)
    assert gs.step.shape == ws.step.shape == ()
    assert all(s.dtype == torch.float32 for s in PP.tree_leaves(gs.nu))


# ---------------------------------------------------------- compression
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_grads_equals_reference(with_residual):
    rng = np.random.default_rng(7)
    grads = {"w": (rng.standard_normal((64, 33)) * 3).astype(np.float32),
             "b": {"x": (rng.standard_normal(17) * 1e-3).astype(np.float32),
                   # exact halves of the scale: round half to even
                   "h": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                                 np.float32)}}
    res = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), grads) \
        if with_residual else None
    want = ref_compress(jax.tree.map(jnp.asarray, grads),
                        None if res is None else jax.tree.map(jnp.asarray,
                                                              res))
    got = compress_grads(params_from_jax(grads, "cpu"),
                         None if res is None else params_from_jax(res, "cpu"))
    for g, w in zip(PP.tree_leaves(got[0]), jax.tree.leaves(want[0])):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(PP.tree_leaves(got[1]), jax.tree.leaves(want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(PP.tree_leaves(got[2]), jax.tree.leaves(want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    deq = decompress_grads(got[0], got[1])
    for g, w in zip(PP.tree_leaves(deq),
                    jax.tree.leaves(ref_decompress(want[0], want[1]))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "hubert-xlarge",
                                  "qwen2-vl-7b"])
def test_batch_for_step_bit_for_bit(name, hosts):
    """Token, embedding-input (hubert) and vision-prefix (qwen2-vl)
    batches, for several steps and host splits, and ``device_batch``."""
    rc, pc = _cfgs(name)
    ref = RPipe(rc, RShape("t", 24, 4, "train"), RDataConfig(seed=9))
    port = SyntheticTokenPipeline(pc, ShapeConfig("t", 24, 4, "train"),
                                  DataConfig(seed=9))
    for step in (0, 3, 17):
        for h in range(hosts):
            want = ref.batch_for_step(step, h, hosts)
            got = port.batch_for_step(step, h, hosts)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    dev = port.device_batch(5, "cpu")
    for k, v in ref.batch_for_step(5).items():
        np.testing.assert_array_equal(dev[k].numpy(), v)


# ----------------------------------------------------------- train step
def _three_steps(name, dtype, microbatch, port_dtype=None):
    """Three steps of the reference's and the port's ``make_train_step``
    (remat on, the restart test's schedule: warm-up 2 of 6 steps) from
    the same weights on the same batches; the port's in ``port_dtype``
    (f64: f64 masters, the exact witness) where given.  Returns (ref
    losses, port losses, ref params, port params)."""
    rc, pc = _cfgs(name, dtype)
    ref, params = _weights(rc)
    if port_dtype == "float64":
        _, pc = _cfgs(name, "float64")
        params = PP.tree_map(lambda a: a.double(), params)
    opt = dict(warmup_steps=2, total_steps=6)
    rstep = ref_train_step(rc, RA.AdamWConfig(**opt), microbatch=microbatch)
    pstep = make_train_step(pc, PA.AdamWConfig(**opt), microbatch=microbatch)
    rstate, pstate = RA.init_opt_state(ref), PA.init_opt_state(params)
    fn, rl, pl = None, [], []
    for s in range(3):
        batch = _batch(pc, s, batch=4)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        fn = fn or _strict(rstep, ref, rstate, jb)
        ref, rstate, rinfo = fn(ref, rstate, jb)
        params, pstate, pinfo = pstep(params, pstate, _torch(batch))
        rl.append(float(rinfo["loss"]))
        pl.append(float(pinfo["loss"]))
    assert int(pstate.step) == int(rstate.step) == 3
    return rl, pl, jax.tree.leaves(ref), PP.tree_leaves(params)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_equals_reference(microbatch, dtype):
    """Three steps of ``make_train_step`` at qwen2-0.5b (reduced).  The
    first loss at 1e-5 relative (the same weights).  In f32 every loss at
    1e-5, and each parameter leaf after the steps at 1e-4 relative RMS,
    or ``F32_GAP_RATIO`` times the reference's own f32 error on it (its
    parameters against the port's f64 run, which is first held to them
    at ``WITNESS_CAP``) where that is larger.  In
    bf16 the steps move the weights by gradients that carry bf16's error
    (0.3-0.8 of a bias leaf's norm after three steps, the reference's own
    error against its f32 run), so each later loss and each leaf is held
    within the same ratio times the reference's own bf16 error.
    Measured: f32 losses within 4.3e-7, the biases ``bk``/``bq`` 2.5e-4 to
    3.1e-4 against own errors of 1.0e-4 to 1.7e-4, every other leaf
    within 7.8e-5; bf16 ``bk`` 0.53-0.86 against 0.73-0.78."""
    ratio = _smoke().F32_GAP_RATIO
    rl, pl, rp, pp = _three_steps("qwen2-0.5b", dtype, microbatch)
    keys = _paths(_weights(_cfgs("qwen2-0.5b", dtype)[0])[0])
    assert abs(pl[0] - rl[0]) <= 1e-5 * abs(rl[0])
    if dtype == "float32":
        np.testing.assert_allclose(pl, rl, rtol=1e-5)
        *_, exact = _three_steps("qwen2-0.5b", dtype, microbatch, "float64")
        own = [_rel(w, e) for w, e in zip(rp, exact)]
        for key, e in zip(keys, own):
            assert e <= WITNESS_CAP["train_step"], (key, "witness", e)
    else:
        rl32, _, rp32, _ = _three_steps("qwen2-0.5b", "float32", microbatch)
        for got, want, want32 in zip(pl, rl, rl32):
            assert abs(got - want) <= ratio * abs(want - want32), \
                (got, want, want32)
        own = [_rel(w, w32) for w, w32 in zip(rp, rp32)]
    for key, g, w, e in zip(keys, pp, rp, own):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= max(1e-4, ratio * e), (key, _rel(g, w), e)


def test_microbatch_accumulates_as_the_whole_batch():
    """Microbatching changes the gradient only by rounding: the mean of
    two halves' gradients against the whole batch's, f32 (a dense model:
    an MoE would route each half in groups of its own)."""
    _, pc = _cfgs("qwen3-8b", "float32")
    params = PP.init_params(pc, torch.Generator().manual_seed(1), "cpu")
    batch = _torch(_batch(pc, batch=4))
    l1, g1 = loss_and_grads(pc, params, batch, microbatch=1)
    l2, g2 = loss_and_grads(pc, params, batch, microbatch=2)
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    assert max(_rel(a, b) for a, b in zip(PP.tree_leaves(g2),
                                          PP.tree_leaves(g1))) <= 1e-5


def test_serve_step_is_decode_step():
    _, pc = _cfgs("qwen3-8b", "float32")
    params = PP.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    tok = torch.tensor([[3], [7]])
    pos = torch.tensor([0, 0])
    got, _ = make_serve_step(pc)(params, PM.init_cache(pc, 2, 4, "cpu"),
                                 tok, pos)
    want, _ = PM.decode_step(pc, params, PM.init_cache(pc, 2, 4, "cpu"),
                             tok, pos)
    assert torch.equal(got, want)


# ---------------------------------------------------------- checkpoints
def _ref_state(name="qwen2-0.5b", steps=1):
    """The reference's params and optimizer state after ``steps`` steps."""
    rc, pc = _cfgs(name, "float32")
    ref = RP.init_params(rc, jax.random.PRNGKey(0))
    opt = RA.init_opt_state(ref)
    step = jax.jit(ref_train_step(rc, RA.AdamWConfig(warmup_steps=2)))
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in _batch(rc, s).items()}
        ref, opt, _ = step(ref, opt, batch)
    return rc, pc, jax.tree.map(np.asarray, {"p": ref, "o": opt})


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _port_tree(tree):
    return {"p": params_from_jax(tree["p"], "cpu"),
            "o": opt_state_from_jax(tree["o"], "cpu")}


def _manifest(d, step):
    return json.loads((d / f"step_{step}" / "manifest.json").read_text())


@pytest.mark.parametrize("name", ["qwen2-0.5b", "zamba2-2.7b"])
def test_checkpoint_reference_to_port(tmp_path, name):
    rc, pc, tree = _ref_state(name)
    ref_save(str(tmp_path), 1, tree)
    like = {"p": PP.init_params(pc, device="cpu"),
            "o": PA.init_opt_state(PP.init_params(pc, device="cpu"))}
    assert latest_step(tmp_path) == 1
    got = restore(tmp_path, 1, like, "cpu")
    assert isinstance(got["o"], PA.OptState)
    want = jax.tree.leaves(tree)
    flat = PP.tree_leaves(got["o"].mu) + PP.tree_leaves(got["o"].nu) + \
        [got["o"].step] + PP.tree_leaves(got["p"])
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert int(got["o"].step) == 1


@pytest.mark.parametrize("name", ["qwen2-0.5b", "zamba2-2.7b"])
def test_checkpoint_port_to_reference(tmp_path, name):
    """The port writes the reference's manifest (keys, files, shapes,
    dtypes, in its order) and files the reference restores bit for bit."""
    _, _, tree = _ref_state(name)
    ref_save(str(tmp_path / "ref"), 4, tree)
    save(tmp_path / "port", 4, _port_tree(tree))
    want_m, got_m = _manifest(tmp_path / "ref", 4), \
        _manifest(tmp_path / "port", 4)
    assert list(got_m["leaves"].items()) == list(want_m["leaves"].items())
    assert got_m["step"] == 4
    assert "o::.mu::embed" in got_m["leaves"] and "o::.step" in \
        got_m["leaves"]
    back = ref_restore(str(tmp_path / "port"), 4, jax.tree.map(
        jnp.asarray, tree))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for f in want_m["leaves"].values():
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "step_4" / f["file"]),
            np.load(tmp_path / "ref" / "step_4" / f["file"]))


def test_checkpoint_bf16_leaf(tmp_path):
    """A bf16 leaf is written as the reference writes one (the same .npy
    bytes) and read back bit for bit."""
    a = jnp.asarray(np.random.default_rng(1).standard_normal((5, 3)),
                    jnp.bfloat16)
    ref_save(str(tmp_path / "ref"), 2, {"w": a})
    t = params_from_jax({"w": np.asarray(a)}, "cpu")
    save(tmp_path / "port", 2, t)
    want = (tmp_path / "ref" / "step_2" / "w.npy").read_bytes()
    assert (tmp_path / "port" / "step_2" / "w.npy").read_bytes() == want
    assert _manifest(tmp_path / "port", 2) == _manifest(tmp_path / "ref", 2)
    for src in ("ref", "port"):
        back = restore(tmp_path / src, 2, t, "cpu")["w"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), t["w"].view(torch.int16))


def test_checkpoint_atomic_publish(tmp_path):
    t = {"w": torch.ones(3)}
    save(tmp_path, 1, t)
    save(tmp_path, 2, t)
    (tmp_path / ".tmp_step_3").mkdir()
    assert latest_step(tmp_path) == 2
    assert latest_step(tmp_path / "none") is None
    assert not list(tmp_path.glob(".tmp_step_[12]"))


def test_opt_state_from_jax():
    _, _, tree = _ref_state("olmoe-1b-7b", steps=2)
    got = opt_state_from_jax(tree["o"], "cpu")
    assert isinstance(got, PA.OptState)
    want = tree["o"]
    assert got.step.dtype == torch.int32 and int(got.step) == 2
    for g, w in zip(PP.tree_leaves(got.mu) + PP.tree_leaves(got.nu),
                    jax.tree.leaves(want.mu) + jax.tree.leaves(want.nu)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


# ------------------------------------------------------------- launcher
LAUNCH = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
          "--seq", "32", "--batch", "2"]


def test_launcher_resume_equals_straight_run(tmp_path, capsys):
    """Six steps straight against three steps saved at step 3, then a
    resumed run to step 6: the same losses at rtol 1e-5 (the reference's
    ``test_train_restart_exact``)."""
    straight = LT.main(LAUNCH + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    first = LT.main(LAUNCH + ["--steps", "3", "--ckpt", ck,
                              "--ckpt-every", "3"])
    assert latest_step(ck) == 3
    rest = LT.main(LAUNCH + ["--steps", "6", "--ckpt", ck,
                             "--ckpt-every", "3", "--resume"])
    assert "resumed @ 3" in capsys.readouterr().out
    assert len(straight) == 6 and len(first) == 3 and len(rest) == 3
    np.testing.assert_allclose(first + rest, straight, rtol=1e-5)
    assert latest_step(ck) == 6
    assert all(np.isfinite(straight))


def test_launcher_runs_the_seeded_step():
    """``--seed`` seeds the weights and the data, and the launcher runs
    ``make_train_step`` with ``total_steps = --steps``: its losses equal
    those of the same pieces driven directly, bit for bit."""
    cfg = pcfg.reduced_config(pcfg.get_arch("qwen2-0.5b"))
    losses = LT.main(LAUNCH + ["--steps", "2", "--seed", "4"])
    params, opt = LT.init_state(cfg, 4, "cpu")
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("train", 32, 2, "train"),
                                  DataConfig(seed=4))
    step = make_train_step(cfg, PA.AdamWConfig(total_steps=2))
    *_, infos = LT.train_loop(step, pipe, params, opt, 0, 2, "cpu", log=None)
    assert [i["loss"] for i in infos] == losses


def test_launcher_refuses_a_mesh():
    """Run alone, the launcher has one rank: a mesh of two is refused,
    and no process group is left behind."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        LT.main(LAUNCH + ["--mesh", "2x1"])
    assert not torch.distributed.is_initialized()


def test_train_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = pcfg.reduced_config(pcfg.get_arch("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.init_state(cfg)
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.device_batch(0)
    save(tmp_path, 1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(tmp_path, 1, {"w": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])


def test_forced_routes_replay_a_run():
    """chip_smoke.py's ``routed``, which makes the card's and the CPU's
    f32 train steps take the f64 run's MoE picks: forced to the picks a
    run makes itself, a train step's loss and gradients are the run's
    bit for bit; forced to other picks, they move."""
    _, pc = _cfgs("olmoe-1b-7b", "float32")
    params = PP.init_params(pc, torch.Generator().manual_seed(2), "cpu")
    batch = _torch(_batch(pc))
    routed = _smoke().routed
    (l0, g0), picks = routed(lambda: loss_and_grads(pc, params, batch))
    assert len(picks) == 2 * pc.n_layers          # forward and recompute
    (l1, g1), again = routed(lambda: loss_and_grads(pc, params, batch),
                             picks)
    assert all(map(torch.equal, again, picks))
    assert torch.equal(l0, l1)
    assert all(map(torch.equal, PP.tree_leaves(g0), PP.tree_leaves(g1)))
    other = [(p + 1) % pc.n_experts for p in picks]
    (l2, _), _ = routed(lambda: loss_and_grads(pc, params, batch), other)
    assert not torch.equal(l0, l2)

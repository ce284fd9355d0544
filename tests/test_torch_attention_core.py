"""The attention core of the port's model (``repro_torch.models.layers.
attention_core``: attention over whole sequences, whose backward
``_AttentionCore`` holds one (Sq, Sk) f32 buffer) against the
reference's ``_sdpa_full`` under ``jax.vjp``, on the same numpy-seeded
q, k, v and cotangent: the output and dq, dk and dv.

Cases: causal and full attention; one query group a KV head (G = 1) and
three; a sequence that is a whole number of chunks and one that is not
(the chunk cut to 4 rows by ``monkeypatch``), and the default chunk,
longer than the sequence; the first causal row, whose one key takes all
its weight.  Tolerances: f64 (the reference under ``jax.enable_x64``,
its f32 casts read as f64, ``_Wide``) a relative max error of 1e-10;
f32 and bf16 as the train parity tests (``tests/test_torch_train.py``)
hold gradients, by relative RMS at 1e-4 and 2e-2, and the output as
``test_sdpa_full`` does, elementwise at 1e-5 and 2e-2.  The reference
is compiled to round every bf16 op as its code writes it (``STRICT``).

Memory, over meta tensors with the dry run's live-bytes accounting
(``launch.dryrun._LiveBytes``) at a train_4k length (4096 positions, 16
chunks): a forward under ``no_grad`` keeps nothing of (Sq, Sk) size, and
a forward and backward peak at one (Sq, Sk) f32 buffer plus the chunks'
temporaries, where autograd of ``_sdpa_full`` holds three.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro_torch.models.layers as PL
from repro_torch.launch.dryrun import _LiveBytes
from test_torch_models import _strict

B, K, DH = 2, 2, 8
NP = {"float64": np.float64, "float32": np.float32,
      "bfloat16": np.float32}
JDT = {"float64": jnp.float64, "float32": jnp.float32,
       "bfloat16": jnp.bfloat16}
TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_RMS = {"float32": 1e-4, "bfloat16": 2e-2}
F64_REL = 1e-10


def _inputs(S, G, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in
            ((B, S, K, G, DH), (B, S, K, DH), (B, S, K, DH),
             (B, S, K, G, DH))]


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``: the reference
    casts q and k to f32 for the scores, and in an f64 run its module
    sees this in place of ``jnp``, so it computes in f64 throughout, as
    the port's f64 model does."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference(arrays, dtype, causal, monkeypatch):
    """The reference's output and (dq, dk, dv) in f32 numpy (f64 for
    f64)."""
    def fn(q, k, v, ct):
        out, vjp = jax.vjp(
            lambda q, k, v: RL._sdpa_full(q, k, v, causal, 0), q, k, v)
        return out, vjp(ct)

    if dtype == "float64":
        monkeypatch.setattr(RL, "jnp", _Wide())
    with jax.enable_x64(dtype == "float64"):
        args = [jnp.asarray(a.astype(NP[dtype])).astype(JDT[dtype])
                for a in arrays]
        out, grads = _strict(fn, *args)(*args)
        wide = jnp.float64 if dtype == "float64" else jnp.float32
        return [np.asarray(jnp.asarray(t, wide)) for t in (out, *grads)]


def _port(arrays, dtype, causal):
    q, k, v, ct = (torch.from_numpy(a.astype(NP[dtype])).to(TDT[dtype])
                   for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = PL.attention_core(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v), ct)
    assert all(t.dtype == TDT[dtype] for t in (out, *grads))
    return [t.detach().double().numpy() for t in (out, *grads)]


def _held(got, want, dtype):
    names = ("out", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        if dtype == "float64":
            rel = np.abs(g - w).max() / np.abs(w).max()
            assert rel <= F64_REL, (name, rel)
        elif name == "out":
            np.testing.assert_allclose(g, w, rtol=OUT_TOL[dtype],
                                       atol=OUT_TOL[dtype])
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= GRAD_RMS[dtype], (name, rel)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_core_equals_reference(dtype, causal, G, monkeypatch):
    """13 positions in chunks of 4 rows: three whole chunks and one of
    a single row."""
    monkeypatch.setattr(PL, "ATTN_CORE_ROWS", 4)
    arrays = _inputs(13, G)
    _held(_port(arrays, dtype, causal),
          _reference(arrays, dtype, causal, monkeypatch), dtype)


@pytest.mark.parametrize("rows", [4, None])
@pytest.mark.parametrize("causal", [True, False])
def test_core_whole_chunks_and_one_chunk(causal, rows, monkeypatch):
    """12 positions in three whole chunks of 4 rows, and in one chunk
    (the default ``ATTN_CORE_ROWS``, longer than the sequence), f64."""
    if rows:
        monkeypatch.setattr(PL, "ATTN_CORE_ROWS", rows)
    arrays = _inputs(12, 2, seed=1)
    _held(_port(arrays, "float64", causal),
          _reference(arrays, "float64", causal, monkeypatch),
          "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_first_causal_row_takes_its_one_key(dtype, monkeypatch):
    """Row 0 of a causal sequence sees key 0 alone: its weight is 1 and
    every other weight 0 exactly (``MASKED`` is -1e30), so its output is
    v's row 0 and its dq is 0, exactly, as the reference's."""
    monkeypatch.setattr(PL, "ATTN_CORE_ROWS", 4)
    arrays = _inputs(9, 2, seed=2)
    out, dq, dk, dv = _port(arrays, dtype, True)
    want = _reference(arrays, dtype, True, monkeypatch)
    v0 = arrays[2][:, 0].astype(NP[dtype]).astype(np.float64)
    np.testing.assert_array_equal(out[:, 0], np.broadcast_to(
        v0[:, :, None, :], out[:, 0].shape))
    np.testing.assert_array_equal(dq[:, 0], 0.0)
    np.testing.assert_array_equal(want[1][:, 0], 0.0)
    _held([out, dq, dk, dv], want, dtype)


def _live_bytes(fn, grad, shape=(2, 4096, 2, 4, 64)):
    """The most bytes ``fn`` (attention over meta tensors of ``shape``,
    bf16, causal) holds at once beyond its inputs: a forward, and with
    ``grad`` its backward from a cotangent; and one (Sq, Sk) f32 buffer's
    bytes."""
    Bm, S, Km, G, dh = shape
    q, k, v, ct = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                   for s in (shape, (Bm, S, Km, dh), (Bm, S, Km, dh),
                             shape))
    for t in (q, k, v):
        t.requires_grad_(grad)
    with _LiveBytes([q, k, v, ct]) as live, torch.set_grad_enabled(grad):
        out = fn(q, k, v, True)
        if grad:
            grads = torch.autograd.grad(out, (q, k, v), ct)
            del grads
        del out
    return live.peak - live.start, Bm * Km * G * S * S * 4


def test_no_grad_forward_keeps_no_scores_buffer():
    """Serving's prefill: O(S * ATTN_CORE_ROWS) score memory, a few
    chunks of the 16 a buffer holds."""
    peak, buffer = _live_bytes(PL.attention_core, grad=False)
    assert peak <= buffer // 4, (peak, buffer)


def test_backward_holds_one_scores_buffer():
    """Forward and backward: the one saved f32 buffer and at most four
    chunks' temporaries (a chunk is a sixteenth of it); autograd of
    ``_sdpa_full`` holds three buffers and more."""
    peak, buffer = _live_bytes(PL.attention_core, grad=True)
    assert buffer <= peak <= buffer + 4 * buffer // 16, (peak, buffer)
    plain, _ = _live_bytes(PL._sdpa_full, grad=True)
    assert plain >= 3 * buffer, (plain, buffer)

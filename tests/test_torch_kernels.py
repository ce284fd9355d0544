"""The port's kernel ops against the JAX package's Pallas kernels.

The same numpy-made inputs go through the JAX kernel in interpret mode
(as ``tests/test_kernels.py`` runs it) and through the port's public ops
on CPU tensors, which run the kernels' plain PyTorch versions.  Every
shape, dtype and causal case of ``tests/test_kernels.py`` is a case here,
at that file's tolerances: attention f32 1e-5, bf16 2e-2; scan f32 2e-4,
bf16 5e-2 (bf16 outputs round at other places in the two frameworks).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_kernel as jax_flash
from repro.kernels.ssm_scan.kernel import selective_scan_kernel as jax_scan
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import (selective_scan_ref,
                                              selective_scan_runs)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attn_inputs(B, Hq, Hkv, S, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d)]
    return [_both(rng.standard_normal(s).astype(np.float32), dtype)
            for s in shapes]


def _scan_inputs(B, S, Di, N, dtype, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, Di)) - 2.0)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.3)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return (_both(x, dtype), _both(dt.astype(np.float32), dtype),
            _both(A.astype(np.float32), "float32"), _both(Bm, dtype),
            _both(Cm, dtype))


def _attn_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _scan_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (1, 4, 4, 256, 64),         # MHA
    (2, 8, 2, 256, 64),         # GQA 4:1
    (1, 4, 1, 512, 128),        # MQA, larger S and head dim
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel(B, Hq, Hkv, S, d, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(B, Hq, Hkv, S, d, dtype)
    want = jax_flash(qj, kj, vj, causal=causal, block_q=128, block_k=128,
                     interpret=True)
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol(dtype))


def _tensor_core_numerics(q, k, v, causal, block_k=64):
    """The roundings of the bf16 tensor-core attention kernel, in plain
    PyTorch: bf16 inputs, f32 Q.K^T (products of bf16 are exact in f32),
    the scale applied after the product, an online softmax over tiles of
    ``block_k`` keys with masked scores at -1e30, l summed from the f32 P,
    and P.V as two products of bf16 operands into one f32 accumulator:
    P's bf16 high part and its bf16 residual, each times V."""
    B, Hq, S, d = q.shape
    G = Hq // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ kt.transpose(-1, -2)) / math.sqrt(d)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        acc = acc * alpha + p_hi @ vt + p_lo @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_match_jax_kernel(d, causal):
    """The bf16 kernel's rounding design, held against the JAX kernel
    (f32 math from bf16 inputs) within the bf16 tolerance."""
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(1, 4, 2, 256, d, "bfloat16",
                                                seed=4)
    want = jax_flash(qj, kj, vj, causal=causal, block_q=128, block_k=128,
                     interpret=True)
    got = _tensor_core_numerics(qt, kt, vt, causal)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol("bfloat16"))


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_large_v_match_jax_kernel(d, causal):
    """q, k and v scaled by 8: the high + residual split holds the JAX
    kernel to the bf16 tolerance at every head dim, with the kernel's kv
    tile of 64 keys.  Rounding P to bf16 before P.V
    instead misses it at d = 96, full attention, on these inputs."""
    (qj, qt), (kj, kt), (vj, vt) = (
        (j * 8, t * 8) for j, t in _attn_inputs(1, 8, 2, 256, d, "bfloat16",
                                                 seed=0))
    want = jax_flash(qj, kj, vj, causal=causal, block_q=128, block_k=128,
                     interpret=True)
    got = _tensor_core_numerics(qt, kt, vt, causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **_attn_tol("bfloat16"))


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (128, 256)])
def test_flash_attention_matches_jax_block_shapes(block_q, block_k):
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(1, 2, 2, 512, 64, "float32",
                                                seed=1)
    want = jax_flash(qj, kj, vj, causal=True, block_q=block_q,
                     block_k=block_k, interpret=True)
    got = flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,Di,N", [
    (1, 256, 512, 16),
    (2, 512, 256, 8),
    (1, 256, 1024, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_matches_jax_kernel(B, S, Di, N, dtype):
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _scan_inputs(
        B, S, Di, N, dtype)
    want = jax_scan(xj, dj, aj, bj, cj, block_d=min(256, Di), block_s=128,
                    interpret=True)
    got = selective_scan(xt, dt_, at, bt, ct)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_scan_tol(dtype))


@pytest.mark.parametrize("block_s", [64, 512])
def test_selective_scan_state_carry_matches_jax(block_s):
    """The port's scan carries h the whole sequence; the JAX kernel
    carries it across its sequence blocks."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _scan_inputs(
        1, 512, 128, 8, "float32", seed=3)
    want = jax_scan(xj, dj, aj, bj, cj, block_d=128, block_s=block_s,
                    interpret=True)
    got = selective_scan(xt, dt_, at, bt, ct)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,Di,N", [(1, 256, 64, 16), (2, 130, 48, 8)])
@pytest.mark.parametrize("run_len,runs_per_chunk", [
    (8, 4),             # the kernel's runs and chunks; divides S = 256
    (8, None), (7, 4), (64, None), (100, 3)])
def test_selective_scan_runs_matches_jax_kernel(B, S, Di, N, run_len,
                                                runs_per_chunk):
    """The CUDA scan kernel's algebra (runs scanned from zero, the
    (prod of decays, h) fold, the replay from the true carry, exp as
    2 ** (dt * A log2 e)) in plain PyTorch, against the JAX kernel and the
    plain sequential version, at run lengths that do and do not divide
    S, f32."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _scan_inputs(
        B, S, Di, N, "float32", seed=5)
    want = jax_scan(xj, dj, aj, bj, cj, block_d=Di, block_s=S,
                    interpret=True)
    got = selective_scan_runs(xt, dt_, at, bt, ct, run_len, runs_per_chunk)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_scan_tol("float32"))
    torch.testing.assert_close(got, selective_scan_ref(xt, dt_, at, bt, ct),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_path(causal):
    """``use_kernel=False`` runs the plain version, and on CPU tensors the
    wrapper runs it too, without a launch."""
    _, (qt, kt, vt) = zip(*_attn_inputs(1, 4, 2, 128, 64, "float32"))
    fa_kernel.reset_launches()
    plain = flash_attention(qt, kt, vt, causal=causal, use_kernel=False)
    assert torch.equal(plain, attention_ref(qt, kt, vt, causal=causal))
    assert torch.equal(flash_attention(qt, kt, vt, causal=causal), plain)
    assert fa_kernel.LAUNCHES == {"flash_attention_kernel": 0}


def test_selective_scan_plain_path():
    args = [t for _, t in _scan_inputs(1, 64, 64, 4, "float32")]
    ss_kernel.reset_launches()
    plain = selective_scan(*args, use_kernel=False)
    assert torch.equal(plain, selective_scan_ref(*args))
    assert torch.equal(selective_scan(*args), plain)
    assert ss_kernel.LAUNCHES == {"selective_scan_kernel": 0}


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    _, (qt, kt, vt) = zip(*_attn_inputs(1, 4, 2, 128, 64, "float32"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(qt.half(), kt.half(), vt.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(qt, kt.bfloat16(), vt)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(qt[:, :3].contiguous(), kt, vt)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(qt[..., :32].contiguous(), kt[..., :32].contiguous(),
                        vt[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(qt.transpose(2, 3), kt, vt)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(qt, kt[:, :, :64].contiguous(),
                        vt[:, :, :64].contiguous())
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(qt.to("meta"), kt.to("meta"), vt.to("meta"))


def test_selective_scan_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = [t for _, t in _scan_inputs(1, 32, 64, 4, "float32")]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        selective_scan(x.double(), dt.double(), A, Bm.double(), Cm.double())
    with pytest.raises(ValueError, match="A: expected contiguous float32"):
        selective_scan(x, dt, A.bfloat16(), Bm, Cm)
    with pytest.raises(ValueError, match="power of two"):
        selective_scan(x, dt, A[:, :3].contiguous(), Bm[..., :3].contiguous(),
                       Cm[..., :3].contiguous())
    with pytest.raises(ValueError, match="Bm: expected"):
        selective_scan(x, dt, A, Bm[:, :16].contiguous(), Cm)


def test_libraries_share_the_build_but_not_the_fmad_rule():
    """The scheduling kernels keep ``--fmad=false`` (bit-exact decisions);
    the attention and scan kernels, held to tolerances, do not."""
    from repro_torch import _nvcc
    from repro_torch.core.backends import cuda
    assert cuda.NVCC_FLAGS[:len(_nvcc.BASE_FLAGS)] == _nvcc.BASE_FLAGS
    assert "--fmad=false" in cuda.NVCC_FLAGS
    for mod in (fa_kernel, ss_kernel):
        assert mod.NVCC_FLAGS == _nvcc.BASE_FLAGS
        assert "--fmad=false" not in mod.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _nvcc.BASE_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    from repro_torch import _nvcc
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _nvcc.build("flash_attention", [fa_kernel.SOURCE],
                    fa_kernel.NVCC_FLAGS)
    assert not (tmp_path / "build").exists()

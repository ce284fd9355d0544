"""The port's kernels on the card, held against their plain versions and
the scalar reference.  The attention and scan kernels are held at the
small shapes of ``tests/test_kernels.py`` (and ragged ones) to the
tolerances stated there, in full f32 (no TF32) for the plain versions.

Every test here is marked ``gpu`` and skips on a host without CUDA.  The
file imports only the port (no JAX, no reference package), so it runs on
a machine that has the card and PyTorch but not JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro_torch import _nvcc
from repro_torch.core.backends import cuda as K
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssm_scan import kernel as SS
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

pytestmark = pytest.mark.gpu

RATES = [(1.0, 0.67, 0.83), (0.83, 0.67, 1.0), (0.67, 0.83, 1.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    return torch.device("cuda")


def _many_routes_topology(rng, P, n_links, R, H, exact=False):
    """R routes of 1 to H hops (exactly H with ``exact``; links drawn with
    repeats) between every pair."""
    links = {f"l{i}": float(s)
             for i, s in enumerate(rng.uniform(0.5, 3.0, size=n_links))}
    routes = {}
    for a in range(P):
        for b in range(a + 1, P):
            hops = [H] * R if exact else \
                rng.integers(1, H + 1, size=R - 1).tolist() + [H]
            routes[(a, b)] = [tuple(f"l{x}" for x in rng.integers(
                0, n_links, size=h)) for h in hops]
    return port.Topology([f"p{i}" for i in range(P)],
                         rng.uniform(0.6, 1.2, size=P), links, routes)


def _instance(kind, seed):
    """Corpus-style instances built with the port's own generators."""
    rng = np.random.default_rng(seed)
    if kind == "paper":
        return port.paper_spg(), port.paper_topology()
    if kind == "case":
        tg = port.paper_topology(rates=RATES[seed % 3])
        g = port.random_spg(int(rng.integers(8, 31)), rng, tg=tg,
                            ccr=[0.1, 1.0, 10.0][(seed // 3) % 3])
        return g, tg
    if kind == "ties":
        # equal rates and link speeds: lanes tie on value and EFT, and
        # the first-index rule of the argmin decides
        tg = port.fully_switched_topology(8, rates=[1.0] * 8,
                                          link_speeds=[1.0] * 8)
        return port.random_spg(40, rng, ccr=1.0, tg=tg, max_in=3,
                               max_out=6), tg
    if kind in ("wide", "p40", "rows"):
        # "p40": more lanes than one warp; "rows": seed tasks on 20 ECUs,
        # whose staged wave and decision scratch take 45.1 KB, so the
        # carried rows fit in ROWS_SMEM_MAX up to about 330 tasks
        P = {"wide": 16, "p40": 40, "rows": 20}[kind]
        tg = port.fully_switched_topology(
            P, rates=rng.uniform(0.6, 1.2, size=P),
            link_speeds=rng.uniform(0.5, 3.0, size=P))
        return port.random_spg(seed if kind == "rows" else 60, rng, ccr=1.0,
                               tg=tg, max_in=3, max_out=6), tg
    if kind in ("multi", "hops", "routes"):
        # "multi": three routes of one or two hops (a route pick);
        # "hops": two routes of exactly seed hops (the hop counts the
        # walk is compiled for); "routes": four of up to eight hops on 32
        # ECUs (the scratch path; a wave is staged a few slots at a time)
        if kind == "hops":
            tg = _many_routes_topology(rng, 8, 8, 2, seed, exact=True)
        elif kind == "multi":
            tg = _many_routes_topology(rng, 12, 10, 3, 2)
        else:
            tg = _many_routes_topology(rng, 32, 16, 4, 8)
        n = {"multi": 60, "hops": 40, "routes": 80}[kind]
        return port.random_spg(n, rng, ccr=1.0, tg=tg, max_in=3,
                               max_out=6), tg
    if kind == "bus":
        # seed ECUs on one shared link; the rates repeat every 512 lanes
        # and the fastest lie below P - 512, so that past 512 lanes (two
        # a thread) a thread's second lane ties with its first and wins
        # once the first is loaded
        rates = rng.choice([0.6, 0.8, 1.0], size=512)
        rates[rng.integers(0, 88, size=3)] = 1.2
        tg = port.Topology([f"p{i}" for i in range(seed)],
                           rates[np.arange(seed) % 512], {"l0": 1.5},
                           {(a, b): [("l0",)] for a in range(seed)
                            for b in range(a + 1, seed)})
        return port.random_spg(40, rng, ccr=1.0, tg=tg, max_in=3,
                               max_out=6), tg
    P = 4                      # routes that visit one link twice
    tg = port.Topology([f"p{i}" for i in range(P)], np.ones(P),
                       {f"l{i}": 1.0 for i in range(P)},
                       {(a, b): [(f"l{a}", f"l{a}")] for a in range(P)
                        for b in range(a + 1, P)})
    return port.random_spg(10, rng, ccr=1.0, tg=tg), tg


CASES = [("paper", 0), ("case", 0), ("case", 29), ("wide", 3),
         ("reuse", 0), ("ties", 0), ("p40", 1), ("rows", 100),
         ("rows", 500), ("multi", 4), ("hops", 1), ("hops", 4),
         ("routes", 2), ("bus", 512), ("bus", 600)]


def _queue(g, tg):
    r = port.rank_matrix(g, tg)
    return r, port.priority_queue(port.hprv_b(g, tg, r), r.mean(1))


@pytest.mark.parametrize("kind,seed", CASES, ids=str)
def test_kernels_equal_plain_on_card(kind, seed, card):
    g, tg = _instance(kind, seed)
    r, q = _queue(g, tg)
    inst = port.CompiledInstance(g, tg, rank=r, device=card)
    be = port.CudaBackend(inst)
    be.start(0.3, inst.default_period, True)
    waves = port.plan_waves(q, inst._preds, port.DEFAULT_BATCH_MAX)
    args = be.stage_plan(waves, [0.0, 0.3, 1.7])
    k, p = K.sched_plan(**args), K.plan_plain(**args)
    for a, b in zip(k[0].tensors() + k[1] + k[2:],
                    p[0].tensors() + p[1] + p[2:]):
        assert torch.equal(a, b)
    wb = port.CudaBackend(inst, scan=False)
    wb.start(0.3, inst.default_period, True)
    for js in waves:
        wargs = wb.stage_wave(js, True)
        kw, pw = K.sched_wave(**wargs), K.wave_plain(**wargs)
        for a, b in zip(kw[0].tensors() + kw[1], pw[0].tensors() + pw[1]):
            assert torch.equal(a, b)
        wb.evaluate_batch(js)


@pytest.mark.parametrize("kind,seed", CASES, ids=str)
def test_card_traces_equal_scalar(kind, seed, card):
    """Both paths and the fused sweep on the card give the scalar
    backend's decision traces, bounds included."""
    g, tg = _instance(kind, seed)
    r, q = _queue(g, tg)
    inst = port.CompiledInstance(g, tg, rank=r, device=card)
    wave_be = port.CudaBackend(inst, scan=False)
    alphas = [0.0, 0.85, 2.0]
    swept = inst.schedule_sweep(q, alphas, backend="cuda")
    for alpha, (s_sw, b_sw, tr_sw) in zip(alphas, swept):
        s, b, tr = inst.schedule_traced(q, alpha, backend="scalar")
        _, bc, trc = inst.schedule_traced(q, alpha, backend="cuda")
        _, bw, trw = inst.schedule_traced(q, alpha, backend=wave_be)
        assert tr.records == trc.records == trw.records == tr_sw.records
        assert b == bc == bw == b_sw
        assert np.array_equal(s.finish, s_sw.finish)


@pytest.mark.parametrize("kind,seed,chunked,rows", [
    ("wide", 3, False, True), ("rows", 100, False, True),
    ("rows", 500, False, False), ("routes", 2, True, False),
    ("p40", 1, False, False)], ids=str)
def test_cases_reach_each_launch_layout(kind, seed, chunked, rows, card):
    """The cases above reach every branch of the kernels' shared-memory
    layout: the carried AFT / placement rows on chip on one side of
    ROWS_SMEM_MAX and in global memory on the other, a wave staged a few
    slots at a time, and P > 32 (two warps a block)."""
    g, tg = _instance(kind, seed)
    r, q = _queue(g, tg)
    inst = port.CompiledInstance(g, tg, rank=r, device=card)
    be = port.CudaBackend(inst)
    waves = port.plan_waves(q, inst._preds, port.DEFAULT_BATCH_MAX)
    B = max(len(w) for w in waves)
    lay = K.launch_layout(be.tables(), be._K, B, g.n)
    assert (lay.chunk < B, lay.rows == g.n) == (chunked, rows), lay
    assert lay.smem <= 232448
    assert (inst.P > 32) == (kind == "p40")


def test_second_lane_of_a_thread_wins_on_card(card):
    """Past 512 processors a decision thread takes two lanes: at P = 600
    some decisions go to a lane of 512 or more, a thread's second."""
    g, tg = _instance("bus", 600)
    r, q = _queue(g, tg)
    inst = port.CompiledInstance(g, tg, rank=r, device=card)
    be = port.CudaBackend(inst)
    be.start(0.3, inst.default_period, True)
    waves = port.plan_waves(q, inst._preds, port.DEFAULT_BATCH_MAX)
    out = K.sched_plan(**be.stage_plan(waves, [0.0, 0.3, 1.7]))[0]
    assert bool((out.win >= 512).any())


def test_session_on_card_counts_one_launch(card):
    g, tg = port.paper_spg(), port.paper_topology()
    K.reset_launches()
    plan = port.Scheduler(tg).submit(
        g, port.HVLB_CC_B(alpha_max=3.0, period=150.0))
    assert plan.backend == "cuda"
    assert (plan.makespan, plan.best_alpha) == (62.0, 1.06)
    assert K.LAUNCHES == {"sched_wave_kernel": 0, "sched_plan_kernel": 1}


def test_sched_library_builds_without_fused_multiply_add(card):
    lib = K.build_library()
    assert "--fmad=false" in lib.built.flags
    assert lib.built.flags[:len(_nvcc.BASE_FLAGS)] == _nvcc.BASE_FLAGS


TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SCAN_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


# the relative RMS error of each block of 64 query rows of a head, the
# limit that scales with the data (chip_smoke.py's ATTN_RMS_LIMIT)
RMS_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _block_rel_rms(got, want, rows=64):
    """The largest ||got - want|| / ||want|| over the blocks of ``rows``
    query rows of every (b, head)."""
    B, H, S, d = want.shape
    pad = -S % rows

    def blocks(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
            B, H, -1, rows * d)

    num = blocks(got.float() - want.float()).norm(dim=-1)
    return float((num / blocks(want.float()).norm(dim=-1).clamp_min(1e-30)
                  ).max())


def _variant(dtype):
    """The per-kernel counts of one launch: bf16 on the tensor cores,
    f32 on the CUDA cores."""
    bf16 = dtype == torch.bfloat16
    return {"wgmma_bf16": int(bf16), "fma_f32": int(not bf16)}


_SHAPES = [(1, 4, 4, 256, 64), (2, 8, 2, 256, 64), (1, 4, 1, 512, 128),
           (1, 14, 2, 200, 64), (2, 4, 4, 130, 80), (1, 4, 2, 100, 96)]
# (B, Hq, Hkv): GQA 1:1, 4:1, 7:1, 8:1, B = 2 in two of them
_HEADS = [(2, 4, 4), (1, 8, 2), (1, 14, 2), (2, 8, 1)]
# the edges of both kernels: every head dim, ragged S below, at and
# above their 128-row query tiles and 64-key kv tiles (S = 1 and 37 below
# one 64-row warpgroup or one 16-row warp of the f32 kernel), every GQA
# ratio, q and k scaled by 8 in every other case (scores up to several
# hundred, so the running max moves across kv tiles), and S = 4096 at
# one head; v scaled too in test_..._large_v_on_card
_EDGES = [(*_HEADS[i % 4], S, d, 8.0 if i % 2 else 1.0)
          for d in (64, 80, 96, 128)
          for i, S in enumerate((1, 37, 64, 100, 130, 200))] + \
    [(1, 1, 1, 4096, d, 8.0) for d in (64, 80, 96, 128)]
_CASES = [(*shape, 1.0, dtype) for shape in _SHAPES
          for dtype in (torch.float32, torch.bfloat16)] + \
    [(*edge, dtype) for edge in _EDGES
     for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("B,Hq,Hkv,S,d,scale,dtype", _CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain_on_card(B, Hq, Hkv, S, d, scale,
                                                     dtype, causal, card):
    rng = np.random.default_rng(0)
    q, k = (_normal(rng, (B, h, S, d), dtype, card) * scale
            for h in (Hq, Hkv))
    v = _normal(rng, (B, Hkv, S, d), dtype, card)
    FA.reset_launches()
    out = flash_attention(q, k, v, causal=causal)
    assert FA.LAUNCHES == {"flash_attention_kernel": 1}
    assert FA.VARIANT_LAUNCHES == _variant(dtype)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert _block_rel_rms(out, want) <= RMS_LIMIT[dtype]


_LARGE_V = [(1, 8, 2, 200, 96), (2, 4, 4, 130, 80), (1, 14, 2, 100, 64),
            (2, 8, 1, 200, 128), (1, 1, 1, 4096, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,S,d", _LARGE_V, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_large_v_on_card(B, Hq, Hkv, S, d, causal,
                                              card):
    """q, k and v all scaled by 8.  The output is a weighted mean of v
    rows, so the error of rounding P to bf16 before P.V grows with |v|,
    and where a row's v values cancel it can pass the absolute part of
    the elementwise bf16 tolerance: SDPA's flash backend, which rounds P
    so, misses it.  The kernel is held here to the relative limit per
    row block and to twice SDPA's error, and by the test below to the
    elementwise tolerance."""
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (B, h, S, d), torch.bfloat16, card) * 8.0
               for h in (Hq, Hkv, Hkv))
    FA.reset_launches()
    out = flash_attention(q, k, v, causal=causal)
    assert FA.VARIANT_LAUNCHES == _variant(torch.bfloat16)
    want = attention_ref(q, k, v, causal=causal)
    G = Hq // Hkv
    with torch.nn.attention.sdpa_kernel(
            torch.nn.attention.SDPBackend.FLASH_ATTENTION):
        lib = torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            is_causal=causal)
    assert _block_rel_rms(out, want) <= RMS_LIMIT[torch.bfloat16]
    err = float((out.float() - want.float()).abs().max())
    lib_err = float((lib.float() - want.float()).abs().max())
    assert err <= 2 * lib_err, (err, lib_err)


@pytest.mark.parametrize("B,Hq,Hkv,S,d", _LARGE_V, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_large_v_elementwise_on_card(B, Hq, Hkv, S, d,
                                                          causal, card):
    """The same inputs (q, k and v scaled by 8) held to the elementwise
    bf16 tolerance of tests/test_kernels.py: P.V adds P's bf16 high part
    and its bf16 residual, so the kernel's products match the plain
    version's f32 P.V."""
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (B, h, S, d), torch.bfloat16, card) * 8.0
               for h in (Hq, Hkv, Hkv))
    FA.reset_launches()
    out = flash_attention(q, k, v, causal=causal)
    assert FA.VARIANT_LAUNCHES == _variant(torch.bfloat16)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("B,S,Di,N", [
    (1, 256, 512, 16), (2, 512, 256, 8), (1, 256, 1024, 16),
    (2, 100, 70, 4), (1, 130, 48, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_selective_scan_kernel_equals_plain_on_card(B, S, Di, N, dtype,
                                                    card):
    rng = np.random.default_rng(2)
    x = _normal(rng, (B, S, Di), dtype, card)
    dt = torch.from_numpy(np.logaddexp(
        0.0, rng.standard_normal((B, S, Di)) - 2.0).astype(np.float32)
    ).to(card, dtype)
    A = torch.from_numpy(-np.exp(rng.standard_normal((Di, N)) * 0.3)
                         .astype(np.float32)).to(card)
    Bm = _normal(rng, (B, S, N), dtype, card)
    Cm = _normal(rng, (B, S, N), dtype, card)
    SS.reset_launches()
    y = selective_scan(x, dt, A, Bm, Cm)
    assert SS.LAUNCHES == {"selective_scan_kernel": 1}
    torch.cuda.synchronize()
    want = selective_scan_ref(x, dt, A, Bm, Cm)
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), want.float(), **SCAN_TOL[dtype])


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_unaligned_on_card(d, causal, card):
    """f32 inputs 4 bytes past a 16-byte boundary: the kernel loads K and
    V with 4-byte copies and q with scalar loads instead of 16-byte
    vectors, with the same result."""
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (1 * h * 150 * d + 1,), torch.float32, card)[1:]
               .view(1, h, 150, d) for h in (4, 2, 2))
    assert all(t.data_ptr() % 16 == 4 for t in (q, k, v))
    FA.reset_launches()
    out = flash_attention(q, k, v, causal=causal)
    assert FA.VARIANT_LAUNCHES == _variant(torch.float32)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    assert torch.equal(out, flash_attention(q.clone(), k.clone(), v.clone(),
                                            causal=causal))


# the scan kernel's edges: S = 1; S and Di ragged against its chunks of
# 32 steps and its blocks of 8, 16 or 32 channels (and rows that are not
# a multiple of 16 bytes, loaded without vectors); every state size;
# S = 4096 with Di = 1024, so the carry crosses 512 runs; dt x 10 (decays
# near 0) and dt x 0.01 (decays near 1); B = 3
_SCAN_EDGES = [(1, 1, 64, 16, 1.0), (1, 33, 17, 16, 1.0),
               (2, 95, 70, 8, 1.0), (1, 31, 1000, 16, 1.0),
               (1, 65, 9, 32, 1.0)] + \
    [(1, 100, 40, n, 1.0) for n in (1, 2, 4, 8, 16, 32)] + \
    [(1, 4096, 1024, 16, 1.0), (1, 300, 256, 16, 10.0),
     (1, 1000, 256, 16, 0.01), (3, 77, 48, 16, 1.0)]


def _scan_inputs_on_card(rng, B, S, Di, N, dtype, dev, dt_scale=1.0):
    x = _normal(rng, (B, S, Di), dtype, dev)
    dt = torch.from_numpy((np.logaddexp(
        0.0, rng.standard_normal((B, S, Di)) - 2.0) * dt_scale
    ).astype(np.float32)).to(dev, dtype)
    A = torch.from_numpy(-np.exp(rng.standard_normal((Di, N)) * 0.3)
                         .astype(np.float32)).to(dev)
    return x, dt, A, _normal(rng, (B, S, N), dtype, dev), \
        _normal(rng, (B, S, N), dtype, dev)


@pytest.mark.parametrize("B,S,Di,N,dt_scale", _SCAN_EDGES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_selective_scan_kernel_edges_on_card(B, S, Di, N, dt_scale, dtype,
                                             card):
    args = _scan_inputs_on_card(np.random.default_rng(3), B, S, Di, N,
                                dtype, card, dt_scale)
    SS.reset_launches()
    y = selective_scan(*args)
    assert SS.LAUNCHES == {"selective_scan_kernel": 1}
    torch.cuda.synchronize()
    want = selective_scan_ref(*args)
    assert y.dtype == dtype and y.shape == args[0].shape
    torch.testing.assert_close(y.float(), want.float(), **SCAN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_selective_scan_kernel_unaligned_on_card(dtype, card):
    """Inputs one element past a 16-byte boundary: the kernel stages them
    with plain loads instead of 16-byte copies, with the same result."""
    rng = np.random.default_rng(4)
    B, S, Di, N = 1, 70, 64, 16

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    x, dt, A, Bm, Cm = _scan_inputs_on_card(rng, B, S, Di, N, dtype, card)
    got = selective_scan(shifted(x), shifted(dt), A, shifted(Bm),
                         shifted(Cm))
    torch.testing.assert_close(got, selective_scan(x, dt, A, Bm, Cm),
                               rtol=0, atol=0)


def test_rejected_shapes_raise_on_card_without_fallback(card):
    rng = np.random.default_rng(5)
    q = _normal(rng, (1, 4, 64, 32), torch.float32, card)
    FA.reset_launches()
    SS.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        x = _normal(rng, (1, 3, 64, 64), torch.float32, card)
        flash_attention(x, x[:, :2].contiguous(), x[:, :2].contiguous())
    with pytest.raises(ValueError, match="several devices"):
        x = _normal(rng, (1, 2, 64, 64), torch.float32, card)
        flash_attention(x, x.cpu(), x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        buf = _normal(rng, (2 * 64 * 64 + 1,), torch.bfloat16, card)
        x = buf[1:].view(1, 2, 64, 64)     # 2 bytes past an aligned start
        flash_attention(x, x, x)
    x = _normal(rng, (1, 16, 32), torch.float32, card)
    A = _normal(rng, (32, 64), torch.float32, card)
    Bm = _normal(rng, (1, 16, 64), torch.float32, card)
    with pytest.raises(ValueError, match="power of two"):
        selective_scan(x, x, A, Bm, Bm)
    assert FA.LAUNCHES == {"flash_attention_kernel": 0}
    assert FA.VARIANT_LAUNCHES == {"wgmma_bf16": 0, "fma_f32": 0}
    assert SS.LAUNCHES == {"selective_scan_kernel": 0}


def test_libraries_build_once_and_count_exactly_across_threads(
        card, tmp_path, monkeypatch):
    """Four threads build the three kernel libraries at once into an
    empty build directory, then launch: each library is compiled once
    and every thread gets the same handle; a direct ``_nvcc.build`` of
    one name from every thread compiles once too; every launch is
    counted."""
    import threading

    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path)
    for mod in (K, FA, SS):
        monkeypatch.setattr(mod, "_LIB", _nvcc.LibraryCache(mod._load))
    loaders = (K.build_library, FA.build_library, SS.build_library,
                lambda: _nvcc.build("ssm_scan_direct", [SS.SOURCE],
                                    SS.NVCC_FLAGS))
    got = [[None] * len(loaders) for _ in range(4)]
    errors = []
    start = threading.Barrier(4)
    rng = np.random.default_rng(9)
    q = _normal(rng, (1, 4, 100, 64), torch.bfloat16, card)
    x = _normal(rng, (1, 64, 32), torch.float32, card)
    A = -torch.rand((32, 8), device=card) - 0.1
    Bm = _normal(rng, (1, 64, 8), torch.float32, card)
    g, tg = port.paper_spg(), port.paper_topology()
    pol = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    reps = 5

    def work(t):
        try:
            start.wait()
            for b, fn in enumerate(loaders):
                got[t][b] = fn()
            for _ in range(reps):
                flash_attention(q, q, q, causal=True)
                selective_scan(x, x.abs(), A, Bm, Bm)
                port.Scheduler(tg).submit(g, pol)
        except BaseException as e:          # surfaced below
            errors.append(e)

    for mod in (K, FA, SS):
        mod.reset_launches()
    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert not errors, errors
    for b in range(len(loaders)):
        libs = [got[t][b] for t in range(4)]
        if b < 3:
            assert all(lib is libs[0] for lib in libs)
        else:
            # separate loads of one file: one compile, the others load it
            assert sum(lib.build_seconds > 0 for lib in libs) == 1
            assert len({lib.path for lib in libs}) == 1
    assert len(list(tmp_path.glob("lib*.so"))) == 4
    assert FA.LAUNCHES == {"flash_attention_kernel": 4 * reps}
    assert FA.VARIANT_LAUNCHES == {"wgmma_bf16": 4 * reps, "fma_f32": 0}
    assert SS.LAUNCHES == {"selective_scan_kernel": 4 * reps}
    assert K.LAUNCHES == {"sched_wave_kernel": 0,
                          "sched_plan_kernel": 4 * reps}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-8b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_dsms_engine_on_card_equals_cpu(name, card):
    """The serving engine at a reduced size in f32 on the card against
    the same engine on the CPU: the same tokens and query outputs within
    1e-5 each step, plans and holes bit-identical, each plan and replan
    through ``sched_plan_kernel``."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.serve import default_queries
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serve import DSMSEngine

    cfg = dataclasses.replace(reduced_config(get_arch(name)),
                              dtype="float32")
    weights = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engines = []
    for dev in (card, torch.device("cpu")):
        eng = DSMSEngine(cfg, tree_map(lambda a: a.to(dev), weights), 2, 16,
                         device=dev)
        for q in default_queries():
            eng.register(q)
        engines.append(eng)
    gpu, cpu = engines

    def same_plan():
        for f in ("proc", "start", "finish"):
            assert np.array_equal(getattr(gpu.plan, f), getattr(cpu.plan, f))
        assert gpu.holes == cpu.holes and gpu.replans == cpu.replans

    K.reset_launches()
    gpu.ensure_plan()
    assert K.LAUNCHES == {"sched_wave_kernel": 0, "sched_plan_kernel": 1}
    cpu.ensure_plan()
    same_plan()
    toks = np.zeros(2, np.int64)
    for step in range(6):
        if step == 2:
            hub = gpu._graph.pred[gpu._query_nodes[0]][0]
            for eng in engines:
                eng.retime({hub: 1.3})
        if step == 4:
            for eng in engines:
                eng.mark_failed(proc=3)
        same_plan()
        a, b = gpu.step(toks), cpu.step(toks)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        torch.testing.assert_close(a.query_outputs["argmax_conf"].cpu(),
                                   b.query_outputs["argmax_conf"],
                                   **TOL[torch.float32])
        torch.testing.assert_close(a.query_outputs["topk"][0].cpu(),
                                   b.query_outputs["topk"][0],
                                   **TOL[torch.float32])
        assert (a.precise, a.precision) == (b.precise, b.precision)
        toks = a.tokens
    assert K.LAUNCHES["sched_wave_kernel"] == 0
    assert K.LAUNCHES["sched_plan_kernel"] > 2


@pytest.mark.parametrize("tokens", [(4, 1), (4, 16)], ids=["decode",
                                                          "prefill"])
def test_moe_routes_equal_cpu_on_card(tokens, card):
    """olmoe's 64 experts, top 8, at d_model 256 in f32: the picks and the
    dispatch mask on the card equal the CPU's exactly (capacity 1 on a
    decode-sized group), the output within the whole model's 1e-4."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import layers as PL
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_arch("olmoe-1b-7b"), n_layers=1,
                              d_model=256, d_ff=128, dtype="float32")
    p = tree_map(lambda a: a[0], init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["blocks"]["moe"])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tokens + (cfg.d_model,)).astype(np.float32))
    pc = tree_map(lambda a: a.to(card), p)
    want_idx, want_disp, _ = PL.moe_route(cfg, p, x)
    got_idx, got_disp, _ = PL.moe_route(cfg, pc, x.to(card))
    assert torch.equal(got_idx.cpu(), want_idx)
    assert torch.equal(got_disp.cpu(), want_disp)
    torch.testing.assert_close(PL.moe(cfg, pc, x.to(card)).cpu(),
                               PL.moe(cfg, p, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_decode_matches_forward_on_card(name, card):
    """The recurrent decode against the chunked forward, f32 (TF32 off)
    on the card, 16 tokens at a reduced size, at 1e-4."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(reduced_config(get_arch(name)),
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         card)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16))).to(card)
    full = M.forward(cfg, params, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 16, card)
    dec = torch.stack([M.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                     torch.full((2,), t, device=card))[0][:, 0]
                       for t in range(16)], 1)
    torch.testing.assert_close(dec, full, rtol=1e-4, atol=1e-4)


def _smoke():
    """``chip_smoke.py`` as a module (it imports only the port): its
    train-step split and error measure, which its card checks use."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_train_step_on_card_equals_cpu(name, card):
    """One train step at a reduced size on the card against the CPU on
    the same f32 masters and batch: in f64 the loss, every gradient and
    every updated parameter within 1e-9 elementwise; in f32 (TF32 off)
    each by relative RMS within 3 times the CPU's own f32 error on it
    (against its f64 result), chip_smoke.py's ``F32_GAP_RATIO``."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.params import init_params, tree_map

    cfg = reduced_config(get_arch(name))
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("t", 32, 2, "train"))
    smoke, out = _smoke(), {}
    for dt, tdt in (("float64", torch.float64), ("float32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dt)
        for where, dev in (("cpu", torch.device("cpu")), ("card", card)):
            out[dt, where] = [a.cpu() for a in smoke.train_step_leaves(
                c, tree_map(lambda a: a.to(dev, tdt), masters),
                pipe.device_batch(0, dev))]
    for g, w in zip(out["float64", "card"], out["float64", "cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)
    for g, w, e in zip(out["float32", "card"], out["float32", "cpu"],
                       out["float64", "cpu"]):
        assert bool(torch.isfinite(g).all())
        assert smoke.rel_rms(g, w) <= \
            smoke.F32_GAP_RATIO * smoke.rel_rms(w, e)


def test_train_restart_exact_on_card(card, tmp_path):
    """Six steps straight against three steps, a save and restore through
    the port's checkpoint, and three more, on the card (the reference's
    ``test_train_restart_exact`` at its size and rtol; f32 atomics in the
    embedding's gradient make it not bit for bit)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import train as LT
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(reduced_config(get_arch("qwen2-0.5b")),
                              n_layers=2, d_model=64, vocab=128)
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("t", 32, 2, "train"))
    step = make_train_step(cfg, AdamWConfig(warmup_steps=2, total_steps=6))
    p, o = LT.init_state(cfg, 0, "cuda")
    *_, straight = LT.train_loop(step, pipe, p, o, 0, 6, "cuda", log=None)
    p, o = LT.init_state(cfg, 0, "cuda")
    LT.train_loop(step, pipe, p, o, 0, 3, "cuda", str(tmp_path), 3,
                  log=None)
    p, o, start = LT.resume(str(tmp_path), p, o, "cuda")
    assert start == 3 and int(o.step) == 3 and o.step.is_cuda
    *_, rest = LT.train_loop(step, pipe, p, o, 3, 6, "cuda", log=None)
    np.testing.assert_allclose([i["loss"] for i in rest],
                               [i["loss"] for i in straight[3:]], rtol=1e-5)


def test_train_launcher_on_card(card, capsys):
    """``python -m repro_torch.launch.train`` on the card at a reduced
    size: every loss finite."""
    from repro_torch.launch import train as LT

    losses = LT.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "3",
                      "--seq", "32", "--microbatch", "2"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "on cuda" in capsys.readouterr().out

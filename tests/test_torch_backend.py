"""The port's device backend against the reference's, decision for
decision.

``CudaBackend(device="cpu")`` runs the plain PyTorch versions of the two
kernels (``wave_plain``, ``plan_plain``); they are held, with no
tolerance, against the reference ``PallasBackend`` run in float64 and
against the reference scalar backend: the same winners, EST/EFT, message
LST/LFT, candidate coefficients A/B and crossing bounds, on the corpus
slices of ``tests/test_backend_equivalence.py``, through both the
whole-plan path and the per-wave path, and through the fused alpha
sweep.

The reference pallas backend enters float64 through
``jax.experimental.enable_x64()``, which jax 0.9 no longer has; the
fixture below supplies it as ``jax.enable_x64(True)`` for these tests
only, without touching the reference package.  Every reference plan is
checked to have run on pallas with no fallback.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.ranks import hprv_b, priority_queue, rank_matrix
from repro_torch.core import convert
from repro_torch.core.backends import cuda as K
from test_backend_equivalence import (_case, _link_reuse_topology, _wide,
                                      assert_identical)


@pytest.fixture(autouse=True)
def pallas_f64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _to_port(g, tg):
    return (convert.spg_from_arrays(**convert.spg_arrays(g)),
            convert.topology_from_arrays(**convert.topology_arrays(tg)))


def _make(kind, arg):
    if kind == "case":
        return _case(arg)
    if kind == "wide":
        return _wide(arg, 3)
    if kind == "ties":
        # equal rates and link speeds: lanes tie on value and EFT, and
        # the first-index rule of the argmin decides
        tg = ref.fully_switched_topology(8, rates=[1.0] * 8,
                                         link_speeds=[1.0] * 8)
        return ref.random_spg(24, np.random.default_rng(arg), ccr=1.0,
                              tg=tg, max_in=3, max_out=6), tg
    tg = _link_reuse_topology(arg)
    return ref.random_spg(10, np.random.default_rng(0), ccr=1.0, tg=tg), tg


CASES = ([("case", s) for s in range(0, 200, 29)] +
         [("wide", 8), ("wide", 16), ("reuse", 4), ("ties", 0)])


def _setup(kind, arg):
    g, tg = _make(kind, arg)
    r = rank_matrix(g, tg)
    q = priority_queue(hprv_b(g, tg, r), r.mean(1))
    gp, tp = _to_port(g, tg)
    return (ref.CompiledInstance(g, tg, rank=r),
            port.CompiledInstance(gp, tp, rank=r.copy(), device="cpu"), q)


@pytest.mark.parametrize("kind,arg", CASES, ids=str)
def test_plan_path_matches_pallas_f64_and_scalar(kind, arg):
    """Whole-plan path: one plain ``plan_plain`` dispatch per schedule
    against the reference's ``lax.scan`` dispatch."""
    ri, pi, q = _setup(kind, arg)
    for alpha in (0.0, 0.85):
        ss, bs, trs = ri.schedule_traced(q, alpha, backend="scalar")
        _, bp, trp = ri.schedule_traced(q, alpha, backend="pallas")
        sc, bc, trc = pi.schedule_traced(q, alpha, backend="cuda")
        assert trc.records == trp.records == trs.records
        assert bc == bp == bs
        assert_identical(ss, sc)
        # (a route that revisits a link overlaps itself on the reference
        # too: the validator must say the same of both)
        assert port.schedule_violations(sc) == ref.schedule_violations(ss)
    be = pi.backend_instance("cuda")
    assert (be.n_launches, be.n_roundtrips, be.n_state_uploads) == (2, 2, 2)


@pytest.mark.parametrize("kind,arg", [("case", 0), ("case", 29),
                                      ("wide", 8), ("reuse", 4),
                                      ("ties", 0)], ids=str)
def test_wave_path_matches_pallas_f64(kind, arg, monkeypatch):
    """Per-wave path: one plain ``wave_plain`` dispatch per wave against
    the reference's per-wave Pallas kernel (``REPRO_PALLAS_SCAN=0``)."""
    ri, pi, q = _setup(kind, arg)
    monkeypatch.setenv("REPRO_PALLAS_SCAN", "0")
    be = port.CudaBackend(pi, scan=False)
    _, bp, trp = ri.schedule_traced(q, 0.85, backend="pallas")
    _, bc, trc = pi.schedule_traced(q, 0.85, backend=be)
    assert trc.records == trp.records
    assert bc == bp
    n_waves = len({rec[7] for rec in trc.records})
    assert be.n_launches == be.n_roundtrips == n_waves
    assert ri.backend_instance("pallas").n_launches == n_waves


@pytest.mark.parametrize("kind,arg", [("case", 58), ("wide", 16),
                                      ("ties", 0)], ids=str)
def test_fused_sweep_matches_pallas_f64(kind, arg):
    """The fused sweep: every alpha in one dispatch, per-alpha traces
    equal to the reference's vmapped scan."""
    ri, pi, q = _setup(kind, arg)
    alphas = [0.0, 0.4, 1.1, 2.5]
    ref_sw = ri.schedule_sweep(q, alphas, backend="pallas")
    port_sw = pi.schedule_sweep(q, alphas, backend="cuda")
    for (s, b, tr), (sp, bp, trp) in zip(ref_sw, port_sw):
        assert trp.records == tr.records
        assert bp == b
        assert np.array_equal(s.finish, sp.finish)
    be = pi.backend_instance("cuda")
    assert be.n_launches == 1 and be.n_roundtrips == 1


def test_single_evaluate_matches_scalar():
    """``evaluate`` (one non-committing decision) against the scalar
    backend at every step of a schedule."""
    _, pi, q = _setup("case", 29)
    sc = pi.backend_instance("scalar")
    cu = port.CudaBackend(pi, scan=False)
    for be in (sc, cu):
        be.start(0.7, pi.default_period, True)
    for j in q:
        d_s, d_c = sc.evaluate(j), cu.evaluate(j)
        assert d_s == d_c
        for be in (sc, cu):
            be.apply(j, *d_s[:4])


def test_scheduler_plans_match_pallas_f64():
    """Through the session: the reference on pallas (no fallback) and the
    port on the plain kernels give the same plans."""
    g, tg = ref.paper_spg(), ref.paper_topology()
    gp, tp = port.paper_spg(), port.paper_topology()
    for policy, ppolicy in (
            (ref.HSV_CC(), port.HSV_CC()),
            (ref.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25, period=150.0),
             port.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25,
                             period=150.0))):
        pr = ref.Scheduler(tg, backend="pallas").submit(g, policy)
        assert pr.backend == "pallas" and pr.fallback is None
        pp = port.Scheduler(tp, device="cpu").submit(gp, ppolicy)
        assert pp.backend == "cuda"
        assert_identical(pr.schedule, pp.schedule)
        if pr.sweep is not None:
            assert np.array_equal(pr.sweep.makespans, pp.sweep.makespans)
            assert pr.sweep.best_alpha == pp.sweep.best_alpha
            assert pr.holes == pp.holes


def _recording(monkeypatch):
    """Record every lane's values of each ``_decide_plain`` call."""
    calls = []
    decide = K._decide_plain

    def record(*args):
        outs, state = decide(*args)
        calls.append(outs)
        return outs, state

    monkeypatch.setattr(K, "_decide_plain", record)
    return calls


def _assert_winner_rows(out, lanes, lead):
    """``out`` (leading dims ``lead`` + the decision) holds the winner
    lane of the full-lane rows ``lanes`` of one decision: est / eft /
    lst / lft / route gathered at win, ca / cb every lane's."""
    w, est, eft, ca, cb, lst, lft, route = lanes
    ar = torch.arange(w.shape[0])
    wl = w.long()
    got = [x[lead] for x in out.tensors()]
    for g, want in zip(got, (w, est[ar, wl], eft[ar, wl], ca, cb,
                             lst[ar, :, :, wl], lft[ar, :, :, wl],
                             route[ar, :, wl])):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert torch.equal(g, want)


def test_plan_plain_writes_winner_lanes(monkeypatch):
    """``plan_plain`` returns the kernels' winner-lane shapes, equal to
    the full-lane rows of each decision gathered at its winner."""
    _, pi, q = _setup("ties", 0)
    be = pi.backend_instance("cuda")
    be.start(0.0, pi.default_period, True)
    waves = port.plan_waves(q, pi._preds, port.DEFAULT_BATCH_MAX)
    args = be.stage_plan(waves, [0.0, 0.4, 1.7])
    calls = _recording(monkeypatch)
    out = K.plan_plain(**args)[0]
    A, W, B = 3, len(waves), max(len(w) for w in waves)
    P, H, Kp = pi.P, be._H, be._K
    assert [tuple(t.shape) for t in out.tensors()] == [
        (A, W, B), (A, W, B), (A, W, B), (A, W, B, P), (A, W, B, P),
        (A, W, B, Kp, H), (A, W, B, Kp, H), (A, W, B, Kp)]
    assert len(calls) == W * B
    for s, lanes in enumerate(calls):
        _assert_winner_rows(out, lanes, (slice(None), s // B, s % B))


def test_wave_plain_writes_winner_lanes(monkeypatch):
    """``wave_plain`` likewise, wave by wave along a schedule."""
    _, pi, q = _setup("ties", 0)
    be = port.CudaBackend(pi, scan=False)
    be.start(0.85, pi.default_period, True)
    calls = _recording(monkeypatch)
    for js in port.plan_waves(q, pi._preds, port.DEFAULT_BATCH_MAX):
        args = be.stage_wave(js, True)
        calls.clear()
        out, _ = K.wave_plain(**args)
        assert out.lst.shape == (len(js), be._K, be._H)
        assert len(calls) == len(js)
        for b, lanes in enumerate(calls):
            _assert_winner_rows(out, lanes, (slice(b, b + 1),))
        be.evaluate_batch(js)


def test_wrappers_dispatch_on_device():
    """CPU tensors take the plain version and count no launch; tensors on
    several devices are refused."""
    _, pi, q = _setup("case", 0)
    be = pi.backend_instance("cuda")
    be.start(0.0, pi.default_period, True)
    waves = port.plan_waves(q, pi._preds, port.DEFAULT_BATCH_MAX)
    args = be.stage_plan(waves, [0.0, 1.0])
    K.reset_launches()
    out = K.sched_plan(**args)
    plain = K.plan_plain(**args)
    for a, b in zip(out[0].tensors(), plain[0].tensors()):
        assert torch.equal(a, b)
    assert K.LAUNCHES == {"sched_wave_kernel": 0, "sched_plan_kernel": 0}
    with pytest.raises(ValueError, match="several devices"):
        K._on_cuda([torch.zeros(1), torch.zeros(1, device="meta")])


def test_launch_layout_refuses_more_than_1024_lanes():
    """The kernels take up to 1024 processors (two lanes a thread past
    512); more are refused before anything is built or launched."""
    P = 1025
    z = torch.zeros
    T = K.RouteTables(lid=z((P + 1, 1, 1, P), dtype=torch.int32),
                      valid=z((P + 1, 1, P), dtype=torch.int32),
                      nhops=z((P + 1, 1, P), dtype=torch.int32),
                      ct=z((1, P + 1, 1, 1, P), dtype=torch.float64),
                      comp=z((1, P), dtype=torch.float64),
                      ldet=z((1, P), dtype=torch.float64), n_links=1)
    with pytest.raises(ValueError, match="1024 candidate lanes"):
        K.launch_layout(T, 1, 1, 1)


def test_vectorized_crossings_equal_scalar_crossing():
    """The decode's batched crossing bounds are the scalar method's
    floats, near-ties and no-rival cases included."""
    rng = np.random.default_rng(5)
    P = 6
    ca = rng.uniform(1.0, 1e4, size=(40, P))
    cb = rng.uniform(0.0, 1e3, size=(40, P))
    ca[:5, 1] = ca[:5, 0]                 # exact A ties
    cb[:5, 1] = cb[:5, 0]                 # ... with exact B ties
    cb[5:10, 2] = cb[5:10, 0] * (1 + 1e-17)
    ca[10:15] = ca[10:15, :1]             # all rivals equal
    cb[15:20] = 0.0
    win = rng.integers(0, P, size=40)
    win[:10] = 0
    for alpha in (0.0, 0.37, 2.5):
        got = K.crossings(win, ca, cb, alpha)
        want = [port.CandidateEvaluator.crossing(int(w), tuple(a), tuple(b),
                                                 alpha)
                for w, a, b in zip(win, ca, cb)]
        assert got.tolist() == want
    one = K.crossings(np.zeros(3, int), np.ones((3, 1)), np.ones((3, 1)), 1.0)
    assert one.tolist() == [float("inf")] * 3

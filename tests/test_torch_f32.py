"""The device backend's float32 near-tie mode against the reference's.

``CudaBackend`` with ``dtype=torch.float32`` on ``device="cpu"`` runs the
kernels' plain PyTorch versions in float32; the reference's pallas
backend runs its float32 mode under the interpreter
(``REPRO_PALLAS_DTYPE=float32``, set per test by the fixture below;
nothing in the reference package changes).  On the corpus of
``tests/test_backend_equivalence.py`` the two agree bit for bit (each op
is one IEEE float32 rounding on both sides, and neither fuses a multiply
and an add), so the plan path, the per-wave path and the fused sweep are
held to the reference's records with no tolerance: winners, routes,
EST/EFT, message LST/LFT, A/B coefficients and crossing bounds.  Against
the float64 scalar reference the contract is the near-tie policy: the
same decisions outside ``F32_NEAR_TIE_RTOL``, floats within it.

The reference's own float32 tests (``tests/test_pallas_batching.py``:
the near-tie fuzz, scan against per-wave, determinism at the paper's
alpha 1.06) are ported here, beside what the port adds: float32 traces
resumed on the scalar backend and on the float64 device backend, the
paper's fault drill, ``dtype`` validation, Def. 4.1's ``1 + lop * alpha``
pinned to its unfused rounding, and a predecessor tie that exists only
in float32 (two float64 AFTs of a replayed prefix that round to one
float32), where the plan kernel's order, not the float64 one, decodes
the messages.
"""
import fractions

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.ranks import hprv_b, priority_queue, rank_matrix
from repro_torch.core import convert
from repro_torch.core.backends import cuda as K
from repro_torch.core.backends.cuda import F32_NEAR_TIE_RTOL
from test_torch_backend import CASES, _make, _to_port

F32 = torch.float32


@pytest.fixture(autouse=True)
def pallas_f32(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_DTYPE", "float32")


def _setup(kind, arg, dtype=F32):
    g, tg = _make(kind, arg)
    r = rank_matrix(g, tg)
    q = priority_queue(hprv_b(g, tg, r), r.mean(1))
    gp, tp = _to_port(g, tg)
    return (ref.CompiledInstance(g, tg, rank=r),
            port.CompiledInstance(gp, tp, rank=r.copy(), device="cpu",
                                  dtype=dtype), q)


def _msgs(schedule):
    """A schedule's message placements as plain tuples (the two packages'
    ``MessagePlacement`` classes never compare equal)."""
    return {e: (m.src_proc, m.dst_proc, m.route, m.intervals)
            for e, m in schedule.messages.items()}


def _decisions(records):
    """The decisions of a trace: task, processor and each message's
    route."""
    return [(j, p, [(i, route) for (i, route, _) in msgs])
            for (j, p, _, _, msgs, _, _, _) in records]


@pytest.mark.parametrize("kind,arg", CASES, ids=str)
def test_plan_path_matches_pallas_f32(kind, arg):
    """Whole-plan path: ``plan_plain`` in float32 against the reference's
    float32 ``lax.scan`` dispatch, record for record; against the
    float64 scalar reference the same decisions, floats within the
    near-tie band."""
    ri, pi, q = _setup(kind, arg)
    be = pi.backend_instance("cuda")
    assert be.dtype == F32
    _, bp, trp = ri.schedule_traced(q, 0.85, backend="pallas")
    sc, bc, trc = pi.schedule_traced(q, 0.85, backend="cuda")
    ss, _, trs = ri.schedule_traced(q, 0.85, backend="scalar")
    assert trc.records == trp.records
    assert bc == bp
    assert _decisions(trc.records) == _decisions(trs.records)
    np.testing.assert_allclose(sc.finish, ss.finish, rtol=F32_NEAR_TIE_RTOL)
    assert be.tables().ct.dtype == F32
    assert (be.n_launches, be.n_roundtrips, be.n_state_uploads) == (1, 1, 1)


@pytest.mark.parametrize("kind,arg", [("case", 29), ("case", 145),
                                      ("reuse", 4), ("ties", 0)], ids=str)
def test_wave_path_matches_pallas_f32(kind, arg, monkeypatch):
    """Per-wave path: ``wave_plain`` in float32, one dispatch a wave, the
    state carried in float32 from wave to wave, against the reference's
    per-wave float32 kernel (``REPRO_PALLAS_SCAN=0``)."""
    ri, pi, q = _setup(kind, arg)
    monkeypatch.setenv("REPRO_PALLAS_SCAN", "0")
    be = port.CudaBackend(pi, scan=False)
    assert be.dtype == F32
    _, bp, trp = ri.schedule_traced(q, 0.85, backend="pallas")
    _, bc, trc = pi.schedule_traced(q, 0.85, backend=be)
    assert trc.records == trp.records
    assert bc == bp
    assert be._state[0].dtype == F32
    n_waves = len({rec[7] for rec in trc.records})
    assert be.n_launches == be.n_roundtrips == n_waves


@pytest.mark.parametrize("kind,arg", [("case", 58), ("wide", 16),
                                      ("ties", 0)], ids=str)
def test_fused_sweep_matches_pallas_f32(kind, arg):
    """The fused sweep in float32: every alpha in one dispatch, each
    alpha's trace, bound and finish times equal to the reference's
    vmapped float32 scan."""
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


def test_scheduler_plans_match_pallas_f32():
    """Through the session: a float32 session's plans (HVLB_CC_IC's
    sweep, best alpha, holes) equal the reference's pallas session in
    float32, and the placements equal the float64 session's."""
    g, tg = ref.paper_spg(), ref.paper_topology()
    gp, tp = port.paper_spg(), port.paper_topology()
    pr = ref.Scheduler(tg, backend="pallas").submit(
        g, ref.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25, period=150.0))
    assert pr.backend == "pallas" and pr.fallback is None
    pol = port.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25, period=150.0)
    pp = port.Scheduler(tp, device="cpu", dtype=F32).submit(gp, pol)
    p64 = port.Scheduler(tp, device="cpu").submit(gp, pol)
    assert pp.backend == "cuda"
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(pr.schedule, f),
                              getattr(pp.schedule, f))
    assert _msgs(pr.schedule) == _msgs(pp.schedule)
    assert np.array_equal(pr.sweep.makespans, pp.sweep.makespans)
    assert pr.best_alpha == pp.best_alpha and pr.holes == pp.holes
    assert np.array_equal(pp.schedule.proc, p64.schedule.proc)


# ------------------------------------ the reference's own float32 tests
def _two_proc_tie_case(mod, d: float):
    """One exit task whose candidate selection values are exactly
    ``(1.0, 1.0 + d, 2.0)`` (the reference's fixture, built in either
    package)."""
    tg = mod.fully_switched_topology(3, rates=np.ones(3),
                                     link_speeds=np.ones(3))
    g = mod.SPG(n=1, edges=[], weights=np.array([1.0]),
                comp_matrix=np.array([[1.0, 1.0 + d, 2.0]]))
    return g, tg


@pytest.mark.parametrize("mag", [1e-10, 1e-8, 3e-7, 1e-6, 1e-4, 1e-2])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_f32_near_tie_fuzz(mag, sign):
    """Candidate values across the near-tie boundary: above
    ``F32_NEAR_TIE_RTOL`` the float32 winner is the float64 scalar
    reference's; below it the float32-lexicographic argmin (first index
    on exact float32 ties), the reference pallas backend's winner."""
    d = sign * mag
    inst = port.CompiledInstance(*_two_proc_tie_case(port, d),
                                 device="cpu", dtype=F32)
    scalar_win = int(inst.schedule([0], backend="scalar").proc[0])
    assert scalar_win == (1 if d < 0 else 0)
    win = int(inst.schedule([0], backend="cuda").proc[0])
    v0, v1 = np.float32(1.0), np.float32(1.0 + d)
    assert win == (1 if v1 < v0 else 0)
    ref_inst = ref.CompiledInstance(*_two_proc_tie_case(ref, d))
    assert win == int(ref_inst.schedule([0], backend="pallas").proc[0])
    if mag >= F32_NEAR_TIE_RTOL:
        assert win == scalar_win
    # deterministic: a fresh instance, and the per-wave path, agree
    fresh = port.CompiledInstance(*_two_proc_tie_case(port, d),
                                  device="cpu", dtype=F32)
    assert int(fresh.schedule([0], backend="cuda").proc[0]) == win
    wave = fresh.schedule([0], backend=port.CudaBackend(fresh, scan=False))
    assert int(wave.proc[0]) == win


def _paper_like(n, seed):
    tg = port.paper_topology()
    g = port.random_spg(n, np.random.default_rng(seed), ccr=1.0, tg=tg,
                        outdeg_constraint=True)
    r = port.rank_matrix(g, tg)
    return g, tg, r, port.priority_queue(port.hprv_b(g, tg, r), r.mean(1))


def test_scan_f32_matches_wave_and_policy():
    """``random_spg(30, seed 6)`` at alpha 0.85 in float32: the plan path
    equals the per-wave path bit for bit, and the float64 scalar
    reference's placements, with finish times within the band."""
    g, tg, r, q = _paper_like(30, 6)
    inst = port.CompiledInstance(g, tg, rank=r, device="cpu", dtype=F32)
    s = inst.schedule(q, alpha=0.85, backend="scalar")
    p_scan = inst.schedule(q, alpha=0.85, backend="cuda")
    p_wave = inst.schedule(q, alpha=0.85,
                           backend=port.CudaBackend(inst, scan=False))
    assert np.array_equal(p_scan.proc, p_wave.proc)
    assert np.array_equal(p_scan.finish, p_wave.finish)
    assert p_scan.messages == p_wave.messages
    assert np.array_equal(p_scan.proc, s.proc)
    np.testing.assert_allclose(p_scan.finish, s.finish,
                               rtol=F32_NEAR_TIE_RTOL)


def test_f32_schedule_deterministic_and_close():
    """The paper instance at alpha 1.06 in float32: deterministic across
    fresh instances, the scalar reference's placements, finish times
    within the band; at the paper's period 150 the paper's 62."""
    g, tg = port.paper_spg(), port.paper_topology()
    r = port.rank_matrix(g, tg)
    q = port.priority_queue(port.hprv_b(g, tg, r), r.mean(1))
    inst = port.CompiledInstance(g, tg, rank=r, device="cpu", dtype=F32)
    s = inst.schedule(q, alpha=1.06, backend="scalar")
    p = inst.schedule(q, alpha=1.06, backend="cuda")
    assert np.array_equal(s.proc, p.proc)
    np.testing.assert_allclose(p.finish, s.finish, rtol=F32_NEAR_TIE_RTOL)
    p2 = port.CompiledInstance(g, tg, rank=r, device="cpu",
                               dtype=F32).schedule(q, alpha=1.06,
                                                   backend="cuda")
    assert np.array_equal(p.proc, p2.proc)
    assert np.array_equal(p.finish, p2.finish)
    assert inst.schedule(q, alpha=1.06, period=150.0,
                         backend="cuda").makespan == 62.0


# ---------------------------------------------------- what the port adds
def test_f32_trace_resumes_on_scalar_and_on_f64_cuda():
    """A float32 trace is portable: its prefix resumes on the scalar
    backend and on the float64 device backend with the same records
    (the prefix re-committed, the suffix recomputed), and a float32
    session's update on the scalar backend equals the reference pallas
    session's in float32."""
    g, tg, r, q = _paper_like(30, 6)
    inst = port.CompiledInstance(g, tg, rank=r, device="cpu", dtype=F32)
    _, _, tr32 = inst.schedule_traced(q, 0.85, backend="cuda")
    be64 = port.CudaBackend(inst, dtype=torch.float64)
    assert be64.dtype == torch.float64
    for pos in (7, 19):
        _, bs, trs = inst.schedule_traced(q, 0.85, resume=tr32,
                                          resume_pos=pos, backend="scalar")
        _, bc, trc = inst.schedule_traced(q, 0.85, resume=tr32,
                                          resume_pos=pos, backend=be64)
        assert trc.records == trs.records and bc == bs
        assert trs.records[:pos] == tr32.records[:pos]
        assert _decisions(trs.records) == _decisions(tr32.records)
    # the session: a float32 submit, then an update on the scalar backend
    rg = ref.random_spg(30, np.random.default_rng(6), ccr=1.0,
                        tg=ref.paper_topology(), outdeg_constraint=True)
    pol_r = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    pol_p = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    sr = ref.Scheduler(ref.paper_topology(), backend="pallas")
    sp = port.Scheduler(tg, device="cpu", dtype=F32)
    assert sr.submit(rg, pol_r).fallback is None
    sp.submit(g, pol_p)
    late = q[-3]
    ur = sr.update(task_rates={late: 1.3}, policy=pol_r, backend="scalar")
    up = sp.update(task_rates={late: 1.3}, policy=pol_p, backend="scalar")
    assert ur.replay.suffix_start == up.replay.suffix_start > 0
    assert ur.replay.decisions_replayed == up.replay.decisions_replayed
    assert np.array_equal(ur.sweep.makespans, up.sweep.makespans)
    assert np.array_equal(ur.schedule.finish, up.schedule.finish)
    assert _msgs(ur.schedule) == _msgs(up.schedule)


def test_paper_fault_drill_f32():
    """The fault drill in float32: healthy 65, processor 2 down 89, no
    violations, as the reference's pallas session in float32 and the
    float64 session."""
    pol = dict(alpha_max=2.0, alpha_step=0.1)
    s32 = port.Scheduler(port.paper_topology(), device="cpu", dtype=F32,
                         policy=port.HVLB_CC_IC(**pol))
    healthy = s32.submit(port.paper_spg())
    failed = s32.mark_failed(proc=2)
    assert (healthy.makespan, failed.makespan) == (65.0, 89.0)
    assert port.schedule_violations(failed.schedule, s32.faults) == []
    assert failed.backend == "cuda" and failed.fallback is None
    rs = ref.Scheduler(ref.paper_topology(), backend="pallas",
                       policy=ref.HVLB_CC_IC(**pol))
    rs.submit(ref.paper_spg())
    rf = rs.mark_failed(proc=2)
    assert rf.fallback is None
    assert np.array_equal(rf.schedule.finish, failed.schedule.finish)
    assert _msgs(rf.schedule) == _msgs(failed.schedule)
    assert rf.replay.invalidated_by_fault == \
        failed.replay.invalidated_by_fault
    s64 = port.Scheduler(port.paper_topology(), device="cpu",
                         policy=port.HVLB_CC_IC(**pol))
    s64.submit(port.paper_spg())
    assert np.array_equal(s64.mark_failed(proc=2).schedule.proc,
                          failed.schedule.proc)


def test_f32_plans_hold_their_invariants_to_float32_rounding():
    """A float32 plan's times are float32 sums: at the float64 slack the
    validator finds only durations off by a rounding (``est + comp`` in
    float32), at ``FLOAT32_RTOL`` none, under faults too; a float64
    plan is clean at the float64 slack."""
    g, tg, r, q = _paper_like(30, 6)
    for policy in (port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25),
                   port.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25)):
        s32 = port.Scheduler(tg, device="cpu", dtype=F32, policy=policy)
        plans = [s32.submit(g), s32.mark_failed(proc=1)]
        for p32 in plans:
            spec = s32.faults if p32 is plans[-1] else None
            v = port.schedule_violations(p32.schedule, spec)
            assert v and all(": duration " in x for x in v)
            assert port.schedule_violations(
                p32.schedule, spec, rtol=port.FLOAT32_RTOL) == []
        p64 = port.Scheduler(tg, device="cpu", policy=policy).submit(g)
        assert port.schedule_violations(p64.schedule) == []


@pytest.mark.parametrize("bad", [torch.bfloat16, torch.float16, torch.int32,
                                 "float32", np.float32])
def test_dtype_other_than_f32_or_f64_raises(bad):
    """Only ``torch.float64`` (or ``None``, the default) and
    ``torch.float32`` are a dtype; anything else raises at the session,
    the instance, the backend and the service, as the reference's
    ``REPRO_PALLAS_DTYPE=bf16`` does."""
    from repro_torch.service import SchedulerService

    tg = port.paper_topology()
    with pytest.raises(ValueError, match="dtype"):
        port.Scheduler(tg, device="cpu", dtype=bad)
    with pytest.raises(ValueError, match="dtype"):
        port.CompiledInstance(port.paper_spg(), tg, device="cpu", dtype=bad)
    inst = port.CompiledInstance(port.paper_spg(), tg, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        port.CudaBackend(inst, dtype=bad)
    with pytest.raises(ValueError, match="dtype"):
        SchedulerService(tg, device="cpu", dtype=bad)


def test_service_runs_every_tenant_in_its_dtype():
    """``SchedulerService(dtype=)`` (``--dtype float32`` on the command
    line) runs every tenant's session in that dtype: the service's plan
    equals a float32 session's submit_many bit for bit."""
    import argparse
    import asyncio

    from repro_torch.service.__main__ import build_service

    svc = build_service(argparse.Namespace(
        topology="switched:4", workers=2, window=0.0, no_coalesce=False,
        backend="cuda", device="cpu", dtype="float32"))
    assert svc.dtype == F32
    tg = svc.topology
    graphs = [port.random_spg(10, np.random.default_rng(k), tg=tg)
              for k in range(2)]

    async def drive():
        car = svc.client("carA")
        for k, g in enumerate(graphs):
            assert (await car.register(g, name=f"q{k}")).ok
        t = svc._tenants["carA"]
        assert t.sched.dtype == F32
        return t.fleet

    try:
        fleet = asyncio.run(drive())
    finally:
        svc.close()
    want = port.Scheduler(tg, device="cpu", dtype=F32).submit_many(graphs)
    assert fleet.backend == "cuda"
    assert np.array_equal(fleet.schedule.finish, want.schedule.finish)
    assert fleet.schedule.messages == want.schedule.messages


def test_default_is_f64_and_host_backends_ignore_dtype():
    """No dtype is float64; the host backends plan alike under either."""
    tg, g = port.paper_topology(), port.paper_spg()
    assert port.CompiledInstance(g, tg, device="cpu").dtype == torch.float64
    assert port.Scheduler(tg, device="cpu").dtype == torch.float64
    pol = port.HVLB_CC_B(alpha_max=3.0, period=150.0)
    for name in ("scalar", "vector", "auto"):
        a = port.Scheduler(tg, backend=name, dtype=F32).submit(g, pol)
        b = port.Scheduler(tg, backend=name).submit(g, pol)
        assert a.schedule.messages == b.schedule.messages
        assert np.array_equal(a.sweep.makespans, b.sweep.makespans)


def _fused_differs(rng):
    """Float32 ``comp``, ``period`` and ``alpha`` whose Def. 4.1 term
    ``1 + lop * alpha`` (``lop = comp / period``) rounds differently
    fused (one rounding of the exact value) and unfused (the product
    rounded, then the sum): ``(comp, period, alpha, unfused, fused)``."""
    period = np.float32(150.0)
    for _ in range(10000):
        comp = np.float32(rng.uniform(1.0, 100.0))
        alpha = np.float32(rng.uniform(0.5, 3.0))
        lop = comp / period
        unfused = np.float32(1.0) + lop * alpha
        exact = 1 + fractions.Fraction(float(lop)) * \
            fractions.Fraction(float(alpha))
        fused = np.float32(float(exact))   # exact: 49 bits fit a double
        if fused != unfused:
            return comp, period, alpha, unfused, fused
    raise AssertionError("no such case")


def test_def41_balance_term_is_not_fused():
    """Def. 4.1's ``BP = 1 + lop * alpha`` in float32 is two roundings,
    the product's and the sum's, as the scalar reference and the
    reference's algebra write it: on inputs where an FMA would round
    once to a different float32, the committed balance factor of the
    state carry is the unfused one, in the per-wave path's carry and the
    plan path's final state alike.  The reference's per-wave kernel under
    the interpreter carries the fused float: XLA:CPU contracts the
    multiply and the add (``ROADMAP.md`` section 3).  BP is in no record,
    so the corpus above still agrees bit for bit; the two can part only
    at a decision whose values lie within one rounding of BP."""
    comp, period, alpha, unfused, fused = _fused_differs(
        np.random.default_rng(41))
    row = [float(comp), 1e4, 1e4]
    g = port.SPG(n=1, edges=[], weights=np.array([1.0]),
                 comp_matrix=np.array([row]))
    tg = port.fully_switched_topology(3, rates=np.ones(3),
                                      link_speeds=np.ones(3))
    inst = port.CompiledInstance(g, tg, device="cpu", dtype=F32)
    be = port.CudaBackend(inst, scan=False)
    be.start(float(alpha), float(period), False)
    (d,) = be.evaluate_batch([0])
    assert d[0] == 0
    bp = be._state[4][0]
    assert bp.item() == unfused != fused
    plan = port.CudaBackend(inst)
    plan.start(float(alpha), float(period), False)
    args = plan.stage_plan([[0]], None)
    _, st, _, _ = K.plan_plain(**args)
    assert st[4][0, 0].item() == unfused
    # the reference's per-wave float32 kernel, under the interpreter
    rg = ref.SPG(n=1, edges=[], weights=np.array([1.0]),
                 comp_matrix=np.array([row]))
    rtg = ref.fully_switched_topology(3, rates=np.ones(3),
                                      link_speeds=np.ones(3))
    rbe = ref.CompiledInstance(rg, rtg).backend_instance("pallas")
    rbe.start(float(alpha), float(period), False)
    rbe.evaluate_batch([0])
    assert float(np.asarray(rbe._state[4])[0]) == fused


def _f32_tie_graph(mod, eps):
    """Three ECUs on one switch; tasks 0 and 1 (entry) feed task 2 over
    edges of volume 3 and 1.  Task 0 finishes at ``1 + eps`` on p1, task
    1 at ``1.0`` on p2; both messages then share task 2's down-link."""
    tg = mod.fully_switched_topology(3, rates=np.ones(3),
                                     link_speeds=np.ones(3))
    g = mod.SPG(n=3, edges=[(0, 2), (1, 2)], weights=np.ones(3),
                tpl={(0, 2): 3.0, (1, 2): 1.0},
                comp_matrix=np.array([[1.0 + eps, 50.0, 50.0],
                                      [50.0, 1.0, 50.0],
                                      [5.0, 5.0, 1.0]]))
    return g, tg


def test_f32_only_predecessor_tie_decodes_what_the_kernel_committed():
    """A prefix recorded in float64 (a scalar run) leaves task 2's two
    predecessors with AFTs ``1 + 2**-30`` and ``1.0``: float64 orders
    them (1, 0), but both round to the float32 ``1.0``, so the plan
    kernel, which sorts the AFTs it holds, walks them in id order (0, 1)
    and writes the hop times in that order.  The port decodes in the
    kernel's order: predecessor 0's message is the one that takes the
    shared down-link first.  The reference's scan decode re-sorts by the
    float64 AFTs and pairs each message with the other's hop times (its
    fault, ``ROADMAP.md`` section 3): there predecessor 0's 3-unit message
    crosses its first link in 1 time unit."""
    eps = 2.0 ** -30
    q = [0, 1, 2]
    inst = port.CompiledInstance(*_f32_tie_graph(port, eps), device="cpu",
                                 dtype=F32)
    _, _, tr64 = inst.schedule_traced(q, 0.0, backend="scalar")
    assert [rec[3] for rec in tr64.records[:2]] == [1.0 + eps, 1.0]
    s, _, tr = inst.schedule_traced(q, 0.0, resume=tr64, resume_pos=2,
                                    backend="cuda")
    wave = port.CudaBackend(inst, scan=False)
    _, _, trw = inst.schedule_traced(q, 0.0, resume=tr64, resume_pos=2,
                                     backend=wave)
    assert trw.records == tr.records
    j, p, est, eft, msgs = tr.records[2][:5]
    assert (j, p, est, eft) == (2, 2, 5.0, 6.0)
    # the kernel's order, (0, 1): 0's message takes l3 first
    assert msgs == [(0, ("l1", "l3"), [(0, 1.0, 4.0), (2, 1.0, 4.0)]),
                    (1, ("l2", "l3"), [(1, 1.0, 2.0), (2, 4.0, 5.0)])]
    for (i, _, iv) in msgs:
        volume = {0: 3.0, 1: 1.0}[i]
        assert all(f - st >= volume for (_, st, f) in iv[:1])
    assert port.schedule_violations(s) == []
    # the reference pairs predecessor 0 with predecessor 1's hop times
    rinst = ref.CompiledInstance(*_f32_tie_graph(ref, eps))
    _, _, rtr64 = rinst.schedule_traced(q, 0.0, backend="scalar")
    _, _, rtr = rinst.schedule_traced(q, 0.0, resume=rtr64, resume_pos=2,
                                      backend="pallas")
    rmsgs = {i: iv for (i, _, iv) in rtr.records[2][4]}
    assert rmsgs[0] == [(0, 1.0, 2.0), (2, 4.0, 5.0)]
    assert rmsgs[0][0][2] - rmsgs[0][0][1] < 3.0

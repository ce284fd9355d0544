"""The port's ``VectorBackend`` and backend-name resolution against the
reference's, with no tolerance.

On the corpus of ``tests/test_backend_equivalence.py`` (the 200-graph
mixed corpus on the paper's multi-route topology, wide single-route
topologies with P 8 and 16, every policy's sweep, best schedule and IC
holes, and update replay), the port's vector backend equals the
reference's vector backend and the port's scalar backend in exact float
equality: placements, start and finish times, message routes and
intervals, crossing bounds, sweeps, holes and ``ReplayStats``.

``resolve_backend_name`` gives the reference's names, and raises the
reference's errors (``BackendCompatError`` for an explicit ``"vector"``
on a topology whose routes revisit a link, ``ValueError`` for an unknown
name), on every (name, P, topology) of a grid.  The one difference by
design: ``None`` is the port's explicit default, ``"cuda"``, where the
reference's default is ``"auto"`` (or its environment variable).
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.backends import resolve_backend_name as ref_resolve
from repro.core.ranks import hprv_b, priority_queue, rank_matrix
from repro_torch.core import convert
from repro_torch.core.backends import (AUTO_VECTOR_MIN_P, BackendCompatError,
                                       resolve_backend_name)
from repro_torch.core.backends.vector import VectorBackend
from test_backend_equivalence import (POLICIES, _case, _link_reuse_topology,
                                      _wide, assert_identical)


def _tp(tg):
    return convert.topology_from_arrays(**convert.topology_arrays(tg))


def _gp(g):
    return convert.spg_from_arrays(**convert.spg_arrays(g))


def _pol(pol):
    return getattr(port, type(pol).__name__)(**dataclasses.asdict(pol))


def _instances(g, tg):
    r = rank_matrix(g, tg)
    q = priority_queue(hprv_b(g, tg, r), r.mean(1))
    return (ref.CompiledInstance(g, tg, rank=r),
            port.CompiledInstance(_gp(g), _tp(tg), rank=r.copy(),
                                  device="cpu"), q)


def _three_way(g, tg, alphas):
    """Single passes and crossing bounds: the port's vector against the
    reference's vector and the port's scalar, on one instance each."""
    ri, pi, q = _instances(g, tg)
    for alpha in alphas:
        want = ri.schedule(q, alpha=alpha, backend="vector")
        for backend in ("vector", "scalar"):
            assert_identical(want, pi.schedule(q, alpha=alpha,
                                               backend=backend))
        rb, bw = ri.schedule_with_bound(q, alpha, backend="vector")
        for backend in ("vector", "scalar"):
            pb, bp = pi.schedule_with_bound(q, alpha, backend=backend)
            assert_identical(rb, pb)
            assert bp == bw                      # exact bound float
    assert isinstance(pi.backend_instance("vector"), VectorBackend)


def assert_plans_identical(rp, pp):
    assert_identical(rp.schedule, pp.schedule)
    assert rp.period == pp.period
    assert rp.holes == pp.holes                  # exact, inf included
    if rp.sweep is None:
        assert pp.sweep is None
    else:
        assert np.array_equal(rp.sweep.alphas, pp.sweep.alphas)
        assert np.array_equal(rp.sweep.makespans, pp.sweep.makespans)
        assert rp.sweep.best_alpha == pp.sweep.best_alpha
    assert dataclasses.asdict(rp.replay) == dataclasses.asdict(pp.replay)


# ------------------------------------------------------------- corpus
@pytest.mark.parametrize("seed", range(200))
def test_vector_equals_reference_on_random_corpus(seed):
    g, tg = _case(seed)
    _three_way(g, tg, (0.0, 0.85))


@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("seed", [3, 17])
def test_vector_equals_reference_on_wide_topology(P, seed):
    g, tg = _wide(P, seed)
    _three_way(g, tg, (0.0, 1.2))
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)
    want = ref.Scheduler(tg, backend="vector").submit(g, pol)
    for backend in ("vector", "scalar"):
        got = port.Scheduler(_tp(tg), backend=backend, device="cpu"
                             ).submit(_gp(g), _pol(pol))
        assert got.backend == backend
        assert_plans_identical(want, got)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: type(p).__name__)
def test_vector_paper_example_policies(policy):
    g, tg = ref.paper_spg(), ref.paper_topology()
    want = ref.Scheduler(tg, backend="vector").submit(g, policy)
    got = port.Scheduler(_tp(tg), backend="vector", device="cpu"
                         ).submit(_gp(g), _pol(policy))
    assert want.backend == got.backend == "vector"
    assert_plans_identical(want, got)
    if isinstance(policy, ref.HVLB_CC_IC):
        assert any(np.isinf(h) for h in got.holes.values())
        for t in got.holes:
            for lam in (0.5, 2.0, 100.0):
                assert got.precision(t, lam) == want.precision(t, lam)


@pytest.mark.parametrize("seed", range(0, 200, 13))
def test_vector_policies_equal_reference(seed):
    """Every policy's sweep, best schedule and IC holes; where a policy's
    queue cannot order the graph, both packages fail the same way."""
    g, tg = _case(seed)
    for policy in POLICIES:
        try:
            want = ref.Scheduler(tg, backend="vector").submit(g, policy)
        except ref.SchedulingFailure:
            with pytest.raises(port.SchedulingFailure):
                port.Scheduler(_tp(tg), backend="vector", device="cpu"
                               ).submit(_gp(g), _pol(policy))
            continue
        for backend in ("vector", "scalar"):
            got = port.Scheduler(_tp(tg), backend=backend, device="cpu"
                                 ).submit(_gp(g), _pol(policy))
            assert_plans_identical(want, got)


@pytest.mark.parametrize("seed,factor", [(0, 0.8), (2, 1.5), (5, 0.7)])
def test_vector_update_replay_equals_reference(seed, factor):
    """``update`` replays as the reference's does: the same suffix start,
    the same replay counters, the same plan."""
    rng = np.random.default_rng(seed)
    tg = ref.paper_topology()
    g = ref.random_spg(40, rng, ccr=1.0, tg=tg, outdeg_constraint=True)
    policy = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5)
    rs = ref.Scheduler(tg, policy=policy, backend="vector")
    ps = port.Scheduler(_tp(tg), policy=_pol(policy), backend="vector",
                        device="cpu")
    r0, p0 = rs.submit(g), ps.submit(_gp(g))
    assert_plans_identical(r0, p0)
    task = int(np.argmax(r0.schedule.start))
    ru, pu = rs.update(task_rates={task: factor}), \
        ps.update(task_rates={task: factor})
    assert pu.backend == "vector"
    assert_plans_identical(ru, pu)


def test_trace_recorded_by_scalar_resumes_under_vector():
    """Traces are backend-portable in the port too: a scalar trace
    replayed by a vector update equals a fresh submit."""
    rng = np.random.default_rng(11)
    tg = _tp(ref.paper_topology())
    g = port.random_spg(40, rng, ccr=1.0, tg=tg, outdeg_constraint=True)
    policy = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5)
    sched = port.Scheduler(tg, policy=policy, device="cpu")
    plan = sched.submit(g, backend="scalar")
    task = int(np.argmax(plan.schedule.start))
    upd = sched.update(task_rates={task: 0.8}, backend="vector")
    assert upd.backend == "vector"
    fresh = port.Scheduler(tg, backend="scalar", device="cpu").submit(
        upd.graph, dataclasses.replace(policy, period=plan.period))
    assert_identical(upd.schedule, fresh.schedule)


# ---------------------------------------------------------- resolution
def _topologies(P):
    disjoint = ref.fully_switched_topology(P, rates=[1.0] * P,
                                           link_speeds=[1.0] * P)
    return {"disjoint": disjoint, "revisiting": _link_reuse_topology(P)}


@pytest.mark.parametrize("kind", ["disjoint", "revisiting"])
@pytest.mark.parametrize("P", [3, 8, 16])
@pytest.mark.parametrize("name", [None, "auto", "scalar", "vector",
                                  "bogus"])
def test_resolve_backend_name_equals_reference(name, P, kind):
    rtg = _topologies(P)[kind]
    ptg = _tp(rtg)
    if name is None:
        # the port's default is its explicit device backend
        assert resolve_backend_name(None, P, ptg) == "cuda"
        return
    try:
        want = ref_resolve(name, P, rtg)
    except ref.backends.BackendCompatError as e:
        with pytest.raises(BackendCompatError, match="scalar"):
            resolve_backend_name(name, P, ptg)
        assert type(e).__mro__[1] is ValueError
        return
    except ValueError:
        with pytest.raises(ValueError, match="unknown backend") as got:
            resolve_backend_name(name, P, ptg)
        assert not isinstance(got.value, BackendCompatError)
        return
    assert resolve_backend_name(name, P, ptg) == want
    if name == "auto":
        assert want == ("vector" if P >= AUTO_VECTOR_MIN_P
                        and kind == "disjoint" else "scalar")


def test_vector_backend_refuses_a_revisiting_route():
    """Defensively at construction too, as the reference's does."""
    tg = _tp(_link_reuse_topology(AUTO_VECTOR_MIN_P))
    g = port.random_spg(10, np.random.default_rng(0), ccr=1.0, tg=tg)
    inst = port.CompiledInstance(g, tg, device="cpu")
    with pytest.raises(BackendCompatError, match="twice"):
        VectorBackend(inst)
    with pytest.raises(BackendCompatError):
        port.Scheduler(tg, backend="vector", device="cpu")
    sched = port.Scheduler(tg, backend="auto", device="cpu")
    assert sched.submit(g, port.HSV_CC()).backend == "scalar"
    with pytest.raises(BackendCompatError, match="use backend='scalar'"):
        sched.submit(g, port.HSV_CC(), backend="vector")
    assert sched.submit(g, port.HSV_CC(), backend="scalar").backend == \
        "scalar"


# -------------------------------------------------------------- "auto"
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: type(p).__name__)
@pytest.mark.parametrize("case", ["paper", "wide8", "wide16"])
def test_auto_session_equals_reference(case, policy):
    """``Scheduler(tg, backend="auto", device="cpu")`` resolves per call
    as the reference's ``Scheduler(tg, backend="auto")`` does, and its
    plans are the reference's bit for bit."""
    if case == "paper":
        g, tg = ref.paper_spg(), ref.paper_topology()
    else:
        g, tg = _wide(int(case[4:]), 5)
    ps = port.Scheduler(_tp(tg), backend="auto", device="cpu")
    assert ps.backend == "auto"
    try:
        want = ref.Scheduler(tg, backend="auto").submit(g, policy)
    except ref.SchedulingFailure:               # HPRV_A cannot order it
        with pytest.raises(port.SchedulingFailure):
            ps.submit(_gp(g), _pol(policy))
        return
    got = ps.submit(_gp(g), _pol(policy))
    assert got.backend == want.backend == \
        ("scalar" if case == "paper" else "vector")
    assert_plans_identical(want, got)
    # a per-call override beats the session's name
    assert ps.submit(_gp(g), _pol(policy), backend="scalar"
                     ).backend == "scalar"

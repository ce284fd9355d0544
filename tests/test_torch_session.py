"""The port's session replanning loop against the reference's, float for
float.

Every script of ``tests/test_session_api.py`` (update, probe_update,
batched and coalesced events, link-speed drift, submit_many) and the
engine equivalences of ``tests/test_engine_equivalence.py``
(``engine="reference"`` == compiled == the deprecated shims) runs through
the reference ``Scheduler(backend="scalar")`` and through the port, on
the kernels' plain versions (``backend="cuda", device="cpu"``) and on
the port's scalar backend.  Plans are compared with no tolerance: every
grid makespan, the best schedule's placements, start and finish times
and message placements, the pinned period, the holes, and
``ReplayStats``.  The port's fused sweep simulates every alpha of a
fresh grid in one dispatch where the reference's host loop skips the
alphas inside each trace's invariance interval, so on a fresh cuda grid
the two simulation counts are held to the fused sweep's own (every
alpha, every task) and every other field to the reference's.

Without a card the port raises unless the CPU is asked for; a watchdog
overrun raises ``WaveTimeoutError`` out of the call, and a failing
kernel raises too: nothing is demoted and no plan carries a fallback.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch._nvcc import KernelError
from repro_torch.core import convert
from repro_torch.core.backends import cuda as K
from test_engine_equivalence import _case as _eq_case
from test_engine_equivalence import assert_identical

BACKENDS = ["cuda", "scalar"]


def _tp(tg):
    return convert.topology_from_arrays(**convert.topology_arrays(tg))


def _gp(g):
    return convert.spg_from_arrays(**convert.spg_arrays(g))


def _pol(mod, pol):
    """The policy ``pol`` of one package as the other package's."""
    return getattr(mod, type(pol).__name__)(**dataclasses.asdict(pol))


def _pair(tg, backend, policy=None, **kw):
    """A reference scalar session and a port session on ``backend``."""
    r = ref.Scheduler(tg, policy=policy, backend="scalar", **kw)
    p = port.Scheduler(_tp(tg), policy=None if policy is None
                       else _pol(port, policy), backend=backend,
                       device="cpu", **kw)
    return r, p


def _fused(plan) -> bool:
    """Whether a port plan came from the fused sweep (a fresh grid of more
    than one alpha on the cuda backend)."""
    pol = plan.policy
    return (plan.backend == "cuda" and not isinstance(pol, port.HSV_CC)
            and pol.sweep == "grid" and len(plan.sweep.alphas) > 1
            and plan.replay.sims_resumed == 0)


def assert_same_plan(rp, pp, backend):
    assert rp.backend == "scalar" and rp.fallback is None
    assert pp.backend == backend and pp.fallback is None
    assert_identical(rp.schedule, pp.schedule)
    assert rp.period == pp.period
    assert rp.holes == pp.holes
    np.testing.assert_array_equal(rp.graph.weights, pp.graph.weights)
    if rp.sweep is None:
        assert pp.sweep is None
    else:
        assert np.array_equal(rp.sweep.alphas, pp.sweep.alphas)
        assert np.array_equal(rp.sweep.makespans, pp.sweep.makespans)
        assert rp.sweep.best_alpha == pp.sweep.best_alpha
    r, p = dataclasses.asdict(rp.replay), dataclasses.asdict(pp.replay)
    if _fused(pp):
        n_alpha = len(pp.sweep.alphas)
        assert p.pop("sims_full") == n_alpha
        assert p.pop("decisions_simulated") == n_alpha * pp.graph.n
        del r["sims_full"], r["decisions_simulated"]
    assert r == p


def _case(seed, n=30):
    rng = np.random.default_rng(seed)
    tg = ref.paper_topology()
    return ref.random_spg(n, rng, ccr=1.0, tg=tg,
                          outdeg_constraint=True), tg


# ------------------------------------------------------------- update
@pytest.mark.parametrize("seed,factor", [(0, 0.8), (1, 0.8), (2, 1.5),
                                         (3, 0.9), (4, 2.0), (5, 0.7),
                                         (6, 1.2), (7, 0.95)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_update_task_rates_equals_reference(seed, factor, backend):
    g, tg = _case(seed)
    pol = ref.HVLB_CC_B(alpha_max=2.0, alpha_step=0.25)
    rs, ps = _pair(tg, backend, pol)
    r0, p0 = rs.submit(g), ps.submit(_gp(g))
    assert_same_plan(r0, p0, backend)
    task = int(np.argmax(r0.schedule.start))      # a late task
    ru, pu = rs.update(task_rates={task: factor}), \
        ps.update(task_rates={task: factor})
    assert_same_plan(ru, pu, backend)
    # the port's update equals its own from-scratch submit too
    fresh = port.Scheduler(ps.topology, backend=backend, device="cpu"
                           ).submit(pu.graph, dataclasses.replace(
                               pu.policy, period=p0.period))
    assert_identical(fresh.schedule, pu.schedule)


@pytest.mark.parametrize("backend", BACKENDS)
def test_probe_update_equals_reference(backend):
    """probe_update's surviving prefix for every sink, then the update
    that reuses the probe."""
    g, tg = _case(11, n=60)
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)
    rs, ps = _pair(tg, backend, pol)
    rs.submit(g)
    ps.submit(_gp(g))
    sinks = [t for t in range(g.n) if not g.succ[t]]
    probes = [(rs.probe_update(task_rates={t: 0.9}),
               ps.probe_update(task_rates={t: 0.9})) for t in sinks]
    assert all(a == b for a, b in probes)
    task = sinks[int(np.argmax([a for a, _ in probes]))]
    assert rs.probe_update(task_rates={task: 0.9}) == \
        ps.probe_update(task_rates={task: 0.9})
    ru, pu = rs.update(task_rates={task: 0.9}), \
        ps.update(task_rates={task: 0.9})
    assert pu.replay.suffix_start > 0 and pu.replay.decisions_replayed > 0
    assert_same_plan(ru, pu, backend)
    assert ps.probe_update(task_rates={task: 1.0}) == g.n


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_chain_equals_reference(backend):
    g, tg = _case(21)
    rs, ps = _pair(tg, backend, ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5))
    assert_same_plan(rs.submit(g), ps.submit(_gp(g)), backend)
    for ev in ({5: 1.3}, {17: 0.6}, {5: 0.9, 2: 1.1}):
        assert_same_plan(rs.update(task_rates=ev), ps.update(task_rates=ev),
                         backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_link_speed_equals_reference(backend):
    g, tg = _case(31)
    rs, ps = _pair(tg, backend, ref.HVLB_CC_B(alpha_max=1.0,
                                              alpha_step=0.25))
    rs.submit(g)
    ps.submit(_gp(g))
    ru, pu = rs.update(link_speed={"l3": 1.5}), \
        ps.update(link_speed={"l3": 1.5})
    assert pu.replay.suffix_start == 0
    assert ps.topology.link_speed == rs.topology.link_speed
    assert_same_plan(ru, pu, backend)
    # a drift after the link change resumes on the new topology
    assert_same_plan(rs.update(task_rates={3: 1.2}),
                     ps.update(task_rates={3: 1.2}), backend)


def test_update_errors_and_noop():
    g, tg = _case(41)
    s = port.Scheduler(_tp(tg), device="cpu",
                       policy=port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5))
    with pytest.raises(ValueError, match="before any submit"):
        s.update(task_rates={0: 2.0})
    with pytest.raises(ValueError, match="before any submit"):
        s.probe_update(task_rates={0: 2.0})
    plan = s.submit(_gp(g))
    with pytest.raises(ValueError, match="unknown links"):
        s.update(link_speed={"nope": 1.0})
    assert s.update(task_rates={3: 1.0}) is plan       # no drift
    assert s.update(task_rates=[{3: 1.0}, {}]) is plan
    upd = s.update(task_rates=[{3: 1.0}, {4: 1.5}])
    assert upd.replay.coalesced == 1
    # the superseded session is evicted; both handles address the new one
    assert len({id(v) for v in s._sessions.values()}) == 1
    assert s._session_of(upd.graph) is s._session_of(plan.graph)


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_hsv_policy_equals_reference(backend):
    g, tg = _case(61)
    rs, ps = _pair(tg, backend, ref.HSV_CC())
    r0 = rs.submit(g)
    assert_same_plan(r0, ps.submit(_gp(g)), backend)
    task = int(np.argmax(r0.schedule.start))
    assert_same_plan(rs.update(task_rates={task: 0.8}),
                     ps.update(task_rates={task: 0.8}), backend)


@pytest.mark.parametrize("policy", [
    ref.HVLB_CC_B(alpha_max=0.0, alpha_step=0.5),       # single-point grid
    ref.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.25),
    ref.HVLB_CC_A(alpha_max=1.0, alpha_step=0.05, sweep="adaptive")],
    ids=["single", "ic", "adaptive"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_update_other_policies_equal_reference(policy, backend):
    g, tg = _case(71)
    rs, ps = _pair(tg, backend, policy)
    r0 = rs.submit(g)
    assert_same_plan(r0, ps.submit(_gp(g)), backend)
    task = int(np.argmax(r0.schedule.start))
    assert_same_plan(rs.update(task_rates={task: 1.4}),
                     ps.update(task_rates={task: 1.4}), backend)


def test_reference_engine_full_replan_equals_reference():
    g, tg = _case(71)
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5)
    rs = ref.Scheduler(tg, policy=pol, engine="reference")
    ps = port.Scheduler(_tp(tg), policy=_pol(port, pol), engine="reference")
    r0, p0 = rs.submit(g), ps.submit(_gp(g))
    assert r0.backend is None and p0.backend is None
    task = int(np.argmax(r0.schedule.start))
    ru, pu = rs.update(task_rates={task: 1.4}), \
        ps.update(task_rates={task: 1.4})
    for a, b in ((r0, p0), (ru, pu)):
        assert_identical(a.schedule, b.schedule)
        assert np.array_equal(a.sweep.makespans, b.sweep.makespans)
        assert dataclasses.asdict(a.replay) == dataclasses.asdict(b.replay)
    assert pu.replay.suffix_start == 0 and pu.replay.decisions_replayed == 0
    assert ps.probe_update(task_rates={task: 1.2}) == 0
    with pytest.raises(ValueError, match="requires"):
        ps.submit(_gp(g), port.HVLB_CC_B(sweep="adaptive"))


# -------------------------------------------------------- submit_many
def _fleet(seed, k, n=None, tg=None):
    rng = np.random.default_rng(seed)
    tg = ref.paper_topology() if tg is None else tg
    return [ref.random_spg(int(rng.integers(8, 20)) if n is None else n,
                           rng, ccr=1.0, tg=tg, outdeg_constraint=True)
            for _ in range(k)], tg


@pytest.mark.parametrize("backend", BACKENDS)
def test_submit_many_equals_reference(backend):
    graphs, tg = _fleet(9, 5)
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)
    rs, ps = _pair(tg, backend, pol)
    rf = rs.submit_many(graphs)
    pf = ps.submit_many([_gp(g) for g in graphs])
    assert pf.offsets == rf.offsets
    assert (pf.backend, pf.fallback, pf.batch) == (backend, None, 16)
    assert pf.period == rf.period and pf.makespan == rf.makespan
    assert_identical(rf.schedule, pf.schedule)
    for k in range(len(graphs)):
        assert_identical(rf.subschedule(k), pf.subschedule(k))
        assert pf.subschedule(k).graph is pf.graphs[k]
        pf.subschedule(k).validate()
    # the union session replays drift keyed by union node ids
    node = pf.offsets[3] + 2
    assert_same_plan(rs.update(task_rates={node: 0.75}),
                     ps.update(task_rates={node: 0.75}), backend)


def test_submit_many_rejects_bad_input():
    s = port.Scheduler(port.paper_topology(), device="cpu")
    with pytest.raises(ValueError, match="tpl convention"):
        s.submit_many([port.paper_spg(ccr=1.0), port.paper_spg(ccr=2.0)])
    with pytest.raises(ValueError, match="at least one graph"):
        s.submit_many([])


# ----------------------------------------------------- batched update
@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_update_equals_reference_and_sequential(backend):
    g, tg = _case(61)
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)
    tr_events = [{3: 1.5}, {7: 0.8, 3: 1.1}, {12: 1.3}]
    ls_events = [{"l1": 0.5}, {"l1": 0.75, "l3": 1.2}]
    rs, ps = _pair(tg, backend, pol)
    rs.submit(g)
    ps.submit(_gp(g))
    rb = rs.update(task_rates=tr_events, link_speed=ls_events)
    pb = ps.update(task_rates=tr_events, link_speed=ls_events)
    assert pb.replay.coalesced == 5
    assert_same_plan(rb, pb, backend)
    # the port's fold equals its own k sequential updates
    seq = port.Scheduler(_tp(tg), policy=_pol(port, pol), backend=backend,
                         device="cpu")
    seq.submit(_gp(g))
    for ev in tr_events:
        seq.update(task_rates=ev)
    for ev in ls_events:
        last = seq.update(link_speed=ev)
    assert last.replay.coalesced == 1
    assert_identical(last.schedule, pb.schedule)
    assert seq.topology.link_speed == ps.topology.link_speed


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_fleet_suffix_replay_equals_reference(backend):
    graphs, tg = _fleet(91, 3, n=12)
    rs, ps = _pair(tg, backend, ref.HVLB_CC_B(alpha_max=1.0,
                                              alpha_step=0.25))
    rs.submit_many(graphs)
    ps.submit_many([_gp(g) for g in graphs])
    off1 = graphs[0].n
    ev = [{off1 + 2: 1.4}, {off1 + 5: 0.8}]
    rb, pb = rs.update(task_rates=ev), ps.update(task_rates=ev)
    assert pb.replay.coalesced == 2
    assert_same_plan(rb, pb, backend)


def test_batched_update_factors_compose_sequentially():
    g, tg = _case(71)
    s = port.Scheduler(_tp(tg), device="cpu",
                       policy=port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5))
    s.submit(_gp(g))
    plan = s.update(task_rates=[{5: 1.1}, {5: 1.2}, {5: 0.7}])
    assert plan.graph.weights[5] == ((g.weights[5] * 1.1) * 1.2) * 0.7


# ----------------------------------------------------- results, policies
def test_sweepresult_curve_and_ic_plan_equal_reference():
    g, tg = ref.paper_spg(), ref.paper_topology()
    pol = ref.HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1, period=150.0)
    rp = ref.Scheduler(tg, backend="scalar").submit(g, pol)
    pp = port.Scheduler(_tp(tg), device="cpu").submit(_gp(g),
                                                      _pol(port, pol))
    from repro_torch.core import deprecation
    deprecation.reset()
    with pytest.warns(DeprecationWarning, match="SweepResult.curve"):
        curve = pp.sweep.curve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert curve == rp.sweep.curve
    assert pp.holes == rp.holes
    for t in pp.holes:
        assert pp.precision(t, 2.0) == rp.precision(t, 2.0)


@pytest.mark.parametrize("seed", [0, 5, 19, 22, 40, 77])
def test_engines_and_shims_equal_reference(seed):
    """engine="reference" == compiled (cuda and scalar) == the deprecated
    shims, in the port and against the reference's scalar session (graphs
    with the out-degree constraint, which HSV_CC's queue needs)."""
    g, tg = _eq_case(seed)
    gp, tp = _gp(g), _tp(tg)
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.1)
    want = ref.Scheduler(tg, policy=pol, backend="scalar").submit(g)
    plans = [port.Scheduler(tp, policy=_pol(port, pol), engine=engine,
                            backend=backend, device="cpu").submit(gp)
             for engine, backend in (("reference", None),
                                     ("compiled", "cuda"),
                                     ("compiled", "scalar"))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shim = port.schedule_hvlb_cc(gp, tp, variant="B", alpha_max=1.0,
                                     alpha_step=0.1, device="cpu")
        shim_best = port.schedule_hvlb_cc_best(gp, tp, variant="B",
                                               alpha_max=1.0,
                                               alpha_step=0.1,
                                               device="cpu")
        hsv = port.schedule_hsv_cc(gp, tp, device="cpu")
        ref_hsv = ref.schedule_hsv_cc(g, tg, backend="scalar")
    for p in plans:
        assert_identical(want.schedule, p.schedule)
        assert np.array_equal(want.sweep.makespans, p.sweep.makespans)
    assert_identical(want.schedule, shim.best)
    assert_identical(want.schedule, shim_best)
    assert np.array_equal(want.sweep.makespans, shim.makespans)
    assert_identical(ref_hsv, hsv)
    s = want.schedule
    ps = plans[1].schedule
    assert (port.slr(ps), port.speedup(ps), port.load_balance(ps)) == \
        (ref.slr(s), ref.speedup(s), ref.load_balance(s))
    assert port.sfr(3, 40) == ref.sfr(3, 40)


def test_shims_warn_once():
    from repro_torch.core import deprecation
    deprecation.reset()
    tg, g = port.paper_topology(), port.paper_spg()
    with pytest.warns(DeprecationWarning, match="schedule_hsv_cc"):
        port.schedule_hsv_cc(g, tg, backend="scalar")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        port.schedule_hsv_cc(g, tg, backend="scalar")    # once per process


# ------------------------------------------- the card, the watchdog, errors
def test_session_paths_need_the_card(monkeypatch):
    """Without CUDA, a session that did not ask for the CPU raises on
    every path a per-call override reaches; nothing runs on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg, g = port.paper_topology(), port.paper_spg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Scheduler(tg, faults=(port.ProcessorDown(1),))
    s = port.Scheduler(tg, backend="scalar")
    s.submit(g, port.HSV_CC())
    for call in (lambda: s.submit_many([g], backend="cuda"),
                 lambda: s.update(task_rates={2: 1.5}, backend="cuda"),
                 lambda: s.mark_failed(proc=1, backend="cuda"),
                 lambda: s.degrade(link="l1", factor=2.0, backend="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert s.faults.is_empty
    # the reference engine schedules on the host and needs no card
    assert port.Scheduler(tg, engine="reference").submit(
        g, port.HSV_CC()).makespan == 73.0


@pytest.mark.parametrize("via_env", [False, True])
def test_watchdog_overrun_raises_out_of_submit(via_env, monkeypatch):
    tg, g = port.paper_topology(), port.paper_spg()
    pol = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    if via_env:
        monkeypatch.setenv("REPRO_SCHED_WAVE_TIMEOUT", "1e-9")
        s = port.Scheduler(tg, device="cpu")
    else:
        s = port.Scheduler(tg, device="cpu", wave_timeout=1e-9)
    assert s.wave_timeout == 1e-9
    with pytest.raises(port.WaveTimeoutError):
        s.submit(g, pol)
    with pytest.raises(port.WaveTimeoutError):
        s.submit(g, port.HSV_CC())
    # the watchdog is the device backend's: the host reference runs on
    # under the same budget, and its plans carry no fallback
    plan = s.submit(g, pol, backend="scalar")
    assert plan.backend == "scalar" and plan.fallback is None
    # an update on the device overruns too, and nothing was cached
    with pytest.raises(port.WaveTimeoutError):
        s.update(task_rates={3: 1.5})
    assert all(p.backend == "scalar" and p.fallback is None
               for sess in s._sessions.values()
               for p in sess.plans.values())
    with pytest.raises(ValueError, match="wave_timeout"):
        port.Scheduler(tg, device="cpu", wave_timeout=0.0)


def test_kernel_failure_raises_without_fallback(monkeypatch):
    """A failing kernel (here its plain version, which the wrapper runs on
    CPU tensors) raises out of submit, update and the fault path."""
    tg, g = port.paper_topology(), port.paper_spg()
    pol = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    s = port.Scheduler(tg, device="cpu", policy=pol)
    plan = s.submit(g)
    assert plan.fallback is None

    def broken(*args, **kwargs):
        raise KernelError("sched_plan_kernel launch failed with CUDA "
                          "error 700")

    monkeypatch.setattr(K, "plan_plain", broken)
    for call in (lambda: s.update(task_rates={3: 1.5}),
                 lambda: s.mark_failed(proc=2),
                 lambda: s.submit(port.paper_spg(ccr=2.0))):
        with pytest.raises(KernelError):
            call()
    assert s.submit(g, backend="scalar").backend == "scalar"


@pytest.mark.parametrize("event", [
    lambda s: s.mark_failed(proc=2),
    lambda s: s.degrade(link="l2", factor=4.0),
    lambda s: s.mark_failed(link="l3"),
    lambda s: s.update(link_speed={"l3": 1.5}),
], ids=["proc_down", "link_degraded", "link_down", "link_speed"])
def test_failed_replan_leaves_no_stale_session(event, monkeypatch):
    """A kernel failure inside a fault or link-speed replan keeps the new
    resource state but drops the pre-event session: a later update cannot
    resume from traces made under the old state, and a re-submit plans
    exactly as a fresh session started in that state."""
    tg, g = port.paper_topology(), port.paper_spg()
    pol = port.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25, period=150.0)
    s = port.Scheduler(tg, device="cpu", policy=pol)
    s.submit(g)
    plain = K.plan_plain

    def broken(*args, **kwargs):
        raise KernelError("sched_plan_kernel launch failed with CUDA "
                          "error 700")

    monkeypatch.setattr(K, "plan_plain", broken)
    with pytest.raises(KernelError):
        event(s)
    monkeypatch.setattr(K, "plan_plain", plain)
    with pytest.raises(ValueError, match="before any submit"):
        s.update(task_rates={3: 1.5})
    plan = s.submit(g)
    assert port.schedule_violations(plan.schedule, s.faults) == []
    fresh = port.Scheduler(s.topology, device="cpu", policy=pol,
                           faults=s.faults._records()).submit(g)
    assert_identical(fresh.schedule, plan.schedule)
    np.testing.assert_array_equal(fresh.sweep.makespans,
                                  plan.sweep.makespans)

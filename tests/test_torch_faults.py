"""The port's fault model and fault replans against the reference's.

The chaos scripts of ``tests/test_chaos.py`` (seeds 0-23, the
reference's reduced set) drive a reference ``Scheduler(backend="scalar")``
and a port session in lockstep, on the kernels' plain versions
(``backend="cuda", device="cpu"``) and on the port's scalar backend:
every event gets the same arguments, and the two must give plans equal
float for float (placements, messages, sweep, ``ReplayStats`` with
``invalidated_by_fault``) or raise the same typed error
(``InfeasibleScheduleError`` on the same task, the last-processor
``ValueError``).  The targeted scripts of that file and the fault drill
of the paper example follow, then the pure fault-spec algebra and masked
views.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from test_chaos import _random_case
from test_torch_session import (BACKENDS, _fused, _gp, _pair, _pol, _tp,
                                assert_same_plan)
from test_engine_equivalence import assert_identical


def _both(calls):
    """Run ``(ref_call, port_call)``: their plans, or the typed error both
    raised (same type, same task for an infeasible placement)."""
    out = []
    for call in calls:
        try:
            out.append(call())
        except (ref.InfeasibleScheduleError, port.InfeasibleScheduleError,
                ValueError) as e:
            out.append(e)
    r, p = out
    if isinstance(r, Exception) or isinstance(p, Exception):
        assert type(r).__name__ == type(p).__name__, (r, p)
        assert str(r) == str(p)
        if isinstance(r, ref.InfeasibleScheduleError):
            assert (r.task, r.eft) == (p.task, p.eft)
        return None
    return r, p


def _same_fault_plan(rp, pp, backend, rs, ps):
    assert_same_plan(rp, pp, backend)
    assert rp.replay.invalidated_by_fault == pp.replay.invalidated_by_fault
    assert ps.faults.down_procs == rs.faults.down_procs
    assert ps.faults.link_factors == rs.faults.link_factors
    assert port.schedule_violations(pp.schedule, ps.faults) == []


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_script_equals_reference(seed, backend):
    rng = np.random.default_rng(100_000 + seed)
    tg, g, pol = _random_case(rng)
    links = tg.all_links()
    rs, ps = _pair(tg, backend, pol)
    gp = _gp(g)
    pair = _both([lambda: rs.submit(g), lambda: ps.submit(gp)])
    assert_same_plan(*pair, backend)
    for _ in range(int(rng.integers(3, 7))):
        op = rng.choice(["proc_down", "link_down", "link_degrade",
                         "task_spike", "drift", "restore"])
        if op == "proc_down":
            up = [p for p in range(tg.n_procs)
                  if p not in rs.faults.down_procs]
            kw = dict(proc=int(rng.choice(up)))
            calls = [lambda: rs.mark_failed(**kw),
                     lambda: ps.mark_failed(**kw)]
        elif op == "link_down":
            kw = dict(link=str(rng.choice(links)))
            calls = [lambda: rs.mark_failed(**kw),
                     lambda: ps.mark_failed(**kw)]
        elif op == "link_degrade":
            kw = dict(link=str(rng.choice(links)),
                      factor=float(rng.choice([1.5, 2., 4.])))
            calls = [lambda: rs.degrade(**kw), lambda: ps.degrade(**kw)]
        elif op == "task_spike":
            kw = dict(task=int(rng.integers(g.n)),
                      factor=float(rng.choice([1.5, 3.0])))
            calls = [lambda: rs.degrade(**kw), lambda: ps.degrade(**kw)]
        elif op == "drift":
            kw = dict(task_rates={int(t): float(0.5 + rng.random())
                                  for t in rng.choice(g.n, size=3,
                                                      replace=False)})
            calls = [lambda: rs.update(**kw), lambda: ps.update(**kw)]
        else:                                   # restore
            spec = rs.faults
            if spec.down_procs and (rng.random() < 0.5
                                    or not spec.link_factors):
                kw = dict(proc=int(rng.choice(spec.down_procs)))
            elif spec.link_factors:
                kw = dict(link=str(rng.choice([l for l, _ in
                                               spec.link_factors])))
            else:
                continue                        # nothing to restore
            calls = [lambda: rs.restore(**kw), lambda: ps.restore(**kw)]
        pair = _both(calls)
        if pair is None:                        # typed, expected: stop
            return
        _same_fault_plan(*pair, backend, rs, ps)


# ---------------------------------------------------------------------
# Targeted fault-replay scripts of tests/test_chaos.py
# ---------------------------------------------------------------------
def _case(seed=0, n=20):
    rng = np.random.default_rng(seed)
    tg = ref.paper_topology()
    return tg, ref.random_spg(n, rng, ccr=1.0, tg=tg, outdeg_constraint=True)


def _crippled(seed=3):
    rng = np.random.default_rng(seed)
    tg = ref.fully_switched_topology(4, rates=[1.0, 1.1, 0.9, 1e-6],
                                     link_speeds=[1.0, 2.0, 1.5, 1.0])
    return tg, ref.random_spg(16, rng, ccr=1.0, tg=tg,
                              outdeg_constraint=True)


_POL = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5)


@pytest.mark.parametrize("script", [
    "unused_proc", "used_proc", "unused_link", "restore", "spike",
    "link_faster", "restore_healthy"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_targeted_fault_scripts_equal_reference(script, backend):
    tg, g = _crippled() if script in ("unused_proc", "unused_link") \
        else _case({"restore": 1, "spike": 6}.get(script, 0))
    rs, ps = _pair(tg, backend, _POL)
    r0, p0 = rs.submit(g), ps.submit(_gp(g))
    assert_same_plan(r0, p0, backend)
    if script == "unused_proc":
        steps = [("mark_failed", dict(proc=3))]
    elif script == "used_proc":
        victim = int(r0.schedule.proc[np.argmin(r0.schedule.start)])
        steps = [("mark_failed", dict(proc=victim))]
    elif script == "unused_link":
        steps = [("degrade", dict(link="l4", factor=4.0))]
    elif script == "restore":
        steps = [("mark_failed", dict(proc=1)), ("restore", dict(proc=1))]
    elif script == "spike":
        steps = [("degrade", dict(task=int(g.topo_order[-1]), factor=2.0))]
    elif script == "link_faster":
        steps = [("degrade", dict(link="l2", factor=4.0)),
                 ("degrade", dict(link="l2", factor=1.5))]
    else:
        steps = [("restore", dict(link="l3"))]
    for name, kw in steps:
        rp, pp = getattr(rs, name)(**kw), getattr(ps, name)(**kw)
        _same_fault_plan(rp, pp, backend, rs, ps)
    if script in ("unused_proc", "unused_link"):
        assert pp.replay.invalidated_by_fault == 0
        assert_identical(p0.schedule, pp.schedule)
    if script == "used_proc":
        assert pp.replay.invalidated_by_fault > 0
    if script == "restore":
        assert ps.faults.is_empty
        assert_identical(p0.schedule, pp.schedule)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kill_last_processor_and_deferred_fault(backend):
    tg, g = _case(2)
    rs, ps = _pair(tg, backend, _POL)
    assert rs.mark_failed(proc=2) is None and ps.mark_failed(proc=2) is None
    assert_same_plan(rs.submit(g), ps.submit(_gp(g)), backend)
    rs.mark_failed(proc=0)
    ps.mark_failed(proc=0)
    for s in (rs, ps):
        with pytest.raises(ValueError, match="every processor marked down"):
            s.mark_failed(proc=1)
    with pytest.raises(ValueError, match="exactly one"):
        ps.mark_failed()
    with pytest.raises(ValueError, match="exactly one"):
        ps.degrade(link="l1", task=0, factor=2.0)
    with pytest.raises(ValueError, match="exactly one"):
        ps.restore(proc=0, link="l1")


@pytest.mark.parametrize("backend", BACKENDS)
def test_faults_argument_equals_mark_failed(backend):
    tg, g = _case(5)
    faults_r = (ref.ProcessorDown(0), ref.LinkDegraded("l2", 2.0))
    faults_p = (port.ProcessorDown(0), port.LinkDegraded("l2", 2.0))
    rs, ps = _pair(tg, backend, _POL)
    ps2 = port.Scheduler(_tp(tg), policy=_pol(port, _POL), backend=backend,
                         device="cpu", faults=faults_p)
    rs2 = ref.Scheduler(tg, policy=_POL, backend="scalar", faults=faults_r)
    assert_same_plan(rs2.submit(g), ps2.submit(_gp(g)), backend)
    ps.submit(_gp(g))
    ps.mark_failed(proc=0)
    pb = ps.degrade(link="l2", factor=2.0)
    assert_identical(ps2.submit(_gp(g)).schedule, pb.schedule)
    with pytest.raises(ValueError, match="ComputeSpike"):
        port.Scheduler(_tp(tg), device="cpu",
                       faults=(port.ComputeSpike(0, 2.0),))


@pytest.mark.parametrize("backend", BACKENDS)
def test_partition_raises_infeasible_like_reference(backend):
    tg = ref.fully_switched_topology(2, rates=[1.0, 1.0],
                                     link_speeds=[1.0, 1.0])
    g = ref.SPG(n=3, edges=[(0, 2), (1, 2)], weights=[4.0, 4.0, 2.0],
                tpl={(0, 2): 2.0, (1, 2): 2.0})
    pol = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=1.0)
    rs, ps = _pair(tg, backend, pol)
    gp = _gp(g)
    assert_same_plan(rs.submit(g), ps.submit(gp), backend)
    assert len(set(ps._last.plans.popitem()[1].schedule.proc[:2])) == 2
    with pytest.raises(port.InfeasibleScheduleError) as ei:
        ps.mark_failed(link="l1")
    with pytest.raises(ref.InfeasibleScheduleError) as er:
        rs.mark_failed(link="l1")
    assert ei.value.task == er.value.task == 2
    # the fault stays recorded: a fresh submit raises until a restore
    with pytest.raises(port.InfeasibleScheduleError):
        ps.submit(gp)
    with pytest.raises(ref.InfeasibleScheduleError):
        rs.submit(g)
    _same_fault_plan(rs.restore(link="l1"), ps.restore(link="l1"), backend,
                     rs, ps)
    assert ps.faults.is_empty


@pytest.mark.parametrize("backend", BACKENDS)
def test_paper_fault_drill(backend):
    """The drill of the repo's notes: healthy 65, 89 once processor 2
    fails, no violation under the active faults."""
    s = port.Scheduler(port.paper_topology(), backend=backend, device="cpu",
                       policy=port.HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1))
    assert s.submit(port.paper_spg()).makespan == 65.0
    p = s.mark_failed(proc=2)
    assert p.makespan == 89.0 and p.backend == backend
    assert 2 not in set(p.proc.tolist())
    assert port.schedule_violations(p.schedule, s.faults) == []
    assert p.replay.invalidated_by_fault > 0
    assert not _fused(p)


# ---------------------------------------------------------------------
# The spec algebra and the masked views
# ---------------------------------------------------------------------
def _spec_pair(tg, records):
    conv = {"ProcessorDown": lambda f: (f.proc,),
            "LinkDown": lambda f: (f.link,),
            "LinkDegraded": lambda f: (f.link, f.factor),
            "ComputeSpike": lambda f: (f.task, f.factor)}
    rr = [getattr(ref, k)(*a) for k, a in records]
    pr = [getattr(port, k)(*a) for k, a in records]
    assert [conv[type(f).__name__](f) for f in pr] == [a for _, a in records]
    return rr, pr


def test_fault_spec_algebra_equals_reference():
    tg = ref.paper_topology()
    tp = _tp(tg)
    records = [("ProcessorDown", (1,)), ("LinkDegraded", ("l2", 2.5)),
               ("LinkDown", ("l3",)), ("LinkDegraded", ("l2", 4.0))]
    rr, pr = _spec_pair(tg, records)
    rspec = ref.FaultSpec.from_faults(rr, tg)
    pspec = port.FaultSpec.from_faults(pr, tp)
    assert dataclasses.astuple(rspec) == dataclasses.astuple(pspec)
    assert pspec.describe() == rspec.describe()
    assert pspec.down_links == rspec.down_links == ("l3",)
    assert [type(f).__name__ for f in pspec._records()] == \
        [type(f).__name__ for f in rspec._records()]
    for extra in (("ProcessorDown", (0,)), ("LinkDegraded", ("l1", 1.5))):
        (re_,), (pe,) = _spec_pair(tg, [extra])
        assert dataclasses.astuple(pspec.with_fault(pe, tp)) == \
            dataclasses.astuple(rspec.with_fault(re_, tg))
    for kw in (dict(proc=1), dict(link="l2"), dict(link="l3"), dict(proc=2)):
        assert dataclasses.astuple(pspec.without(**kw)) == \
            dataclasses.astuple(rspec.without(**kw))
    for link, raw in (("l1", 2.0), ("l2", 3.0), ("l3", 1.0)):
        assert pspec.effective_speed(link, raw) == \
            rspec.effective_speed(link, raw)
    bad = [[("ProcessorDown", (3,))], [("LinkDown", ("nope",))],
           [("LinkDegraded", ("l1", 0.0))],
           [("LinkDegraded", ("l1", math.inf))],
           [("ProcessorDown", (0,)), ("ProcessorDown", (1,)),
            ("ProcessorDown", (2,))], [("ComputeSpike", (0, 2.0))]]
    for recs in bad:
        rr, pr = _spec_pair(tg, recs)
        with pytest.raises(ValueError) as er:
            ref.FaultSpec.from_faults(rr, tg)
        with pytest.raises(ValueError) as ep:
            port.FaultSpec.from_faults(pr, tp)
        assert str(er.value) == str(ep.value)
    with pytest.raises(TypeError):
        port.FaultSpec.from_faults(["not a fault"], tp)


def test_masked_views_equal_reference():
    tg = ref.paper_topology()
    g = ref.random_spg(12, np.random.default_rng(4), ccr=1.0, tg=tg)
    rr, pr = _spec_pair(tg, [("LinkDown", ("l1",)),
                             ("LinkDegraded", ("l2", 2.0))])
    rt = ref.apply_to_topology(tg, ref.FaultSpec.from_faults(rr, tg))
    pt = port.apply_to_topology(_tp(tg),
                                port.FaultSpec.from_faults(pr, _tp(tg)))
    assert pt.link_speed == rt.link_speed and pt.routes == rt.routes
    assert np.array_equal(pt.rates, rt.rates)
    spikes = [("ComputeSpike", (3, 1.5)), ("ComputeSpike", (3, 2.0)),
              ("ComputeSpike", (7, 0.5))]
    rs_, ps_ = _spec_pair(tg, spikes)
    rg, pg = ref.apply_to_graph(g, rs_), port.apply_to_graph(_gp(g), ps_)
    assert np.array_equal(rg.weights, pg.weights)
    assert pg.edges == rg.edges and pg.tpl == rg.tpl
    for recs in ([("ComputeSpike", (99, 2.0))],
                 [("ComputeSpike", (0, -1.0))]):
        rs_, ps_ = _spec_pair(tg, recs)
        with pytest.raises(ValueError):
            port.apply_to_graph(_gp(g), ps_)

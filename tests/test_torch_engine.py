"""The port's engine and scalar backend against the reference's:
bit-identical schedules and identical decision-trace records (batch ids
included) for every wave cap, on the same instances."""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.ranks import hprv_b, priority_queue, rank_matrix
from repro_torch.core import convert
from test_backend_equivalence import (_case, _link_reuse_topology, _wide,
                                      assert_identical)


def _to_port(g, tg):
    return (convert.spg_from_arrays(**convert.spg_arrays(g)),
            convert.topology_from_arrays(**convert.topology_arrays(tg)))


def _instances(g, tg):
    r = rank_matrix(g, tg)
    q = priority_queue(hprv_b(g, tg, r), r.mean(1))
    gp, tp = _to_port(g, tg)
    return (ref.CompiledInstance(g, tg, rank=r),
            port.CompiledInstance(gp, tp, rank=r.copy(), device="cpu"), q)


CASES = ([("paper", None)] + [("case", s) for s in range(0, 200, 23)] +
         [("wide8", 3), ("wide16", 4), ("reuse", 4)])


def _make(kind, arg):
    if kind == "paper":
        return ref.paper_spg(), ref.paper_topology()
    if kind == "case":
        return _case(arg)
    if kind == "wide8":
        return _wide(8, arg)
    if kind == "wide16":
        return _wide(16, arg)
    tg = _link_reuse_topology(arg)
    return ref.random_spg(10, np.random.default_rng(0), ccr=1.0, tg=tg), tg


@pytest.mark.parametrize("kind,arg", CASES, ids=lambda x: str(x))
@pytest.mark.parametrize("batch", [1, 4, 16])
def test_scalar_traces_identical(kind, arg, batch):
    g, tg = _make(kind, arg)
    ri, pi, q = _instances(g, tg)
    preds = [list(g.pred[j]) for j in range(g.n)]
    assert ref.engine.plan_waves(q, preds, batch) == \
        port.plan_waves(q, preds, batch)
    for alpha in (0.0, 0.85):
        s, b, tr = ri.schedule_traced(q, alpha, backend="scalar",
                                      batch=batch)
        sp, bp, trp = pi.schedule_traced(q, alpha, backend="scalar",
                                         batch=batch)
        assert_identical(s, sp)
        assert b == bp
        assert tr.records == trp.records           # batch ids included
        assert (tr.queue, tr.alpha, tr.period) == \
            (trp.queue, trp.alpha, trp.period)
        assert ref.schedule_violations(s) == port.schedule_violations(sp)
    assert ri.n_decisions_simulated == pi.n_decisions_simulated


@pytest.mark.parametrize("seed", range(0, 200, 41))
def test_list_schedule_identical(seed):
    """The readable executable spec, and the compiled engine against it."""
    g, tg = _case(seed)
    gp, tp = _to_port(g, tg)
    r = rank_matrix(g, tg)
    q = priority_queue(hprv_b(g, tg, r), r.mean(1))
    for alpha in (0.0, 1.3):
        s = ref.list_schedule(g, tg, q, r, alpha=alpha)
        sp = port.list_schedule(gp, tp, q, r, alpha=alpha)
        assert_identical(s, sp)
        inst = port.CompiledInstance(gp, tp, rank=r, device="cpu")
        assert_identical(sp, inst.schedule(q, alpha, backend="scalar"))


def test_trace_resume_across_packages():
    """A trace recorded by the reference resumes in the port (records
    are plain floats; the commit is the same scalar code)."""
    g, tg = _case(7)
    ri, pi, q = _instances(g, tg)
    full, _, tr = ri.schedule_traced(q, 0.5, backend="scalar")
    k = len(q) // 2
    s, _, trp = pi.schedule_traced(q, 0.5, resume=tr, resume_pos=k,
                                   backend="scalar")
    _, _, trr = ri.schedule_traced(q, 0.5, resume=tr, resume_pos=k,
                                   backend="scalar")
    assert_identical(full, s)
    # a resumed suffix may split a wave, so its batch ids are the
    # reference resume's, not the fresh run's
    assert trr.records == trp.records
    assert [r[:7] for r in tr.records] == [r[:7] for r in trp.records]
    assert pi.n_decisions_replayed == k


def test_unknown_backend_rejected():
    g, tg = port.paper_spg(), port.paper_topology()
    inst = port.CompiledInstance(g, tg, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        inst.schedule(list(range(10)), backend="pallas")
    assert port.available_backends() == ["cuda", "scalar", "vector"]


@pytest.mark.parametrize("backend", ["scalar", "cuda"])
def test_fault_masking_matches_reference(backend):
    """A down processor and a degraded link mask the instance the same
    way in both packages (finite sentinels, unchanged arithmetic)."""
    g, tg = _case(11)
    ri, _, q = _instances(g, tg)
    spec_r = ref.FaultSpec(down_procs=(1,), link_factors=(("l3", 2.0),))
    spec_p = port.FaultSpec(down_procs=(1,), link_factors=(("l3", 2.0),))
    gp, tp = _to_port(g, tg)
    r = rank_matrix(g, tg)
    inst_r = ref.CompiledInstance(g, tg, rank=r, faults=spec_r)
    inst_p = port.CompiledInstance(gp, tp, rank=r.copy(), faults=spec_p,
                                   device="cpu")
    for alpha in (0.0, 0.6):
        s, b, tr = inst_r.schedule_traced(q, alpha, backend="scalar")
        sp, bp, trp = inst_p.schedule_traced(q, alpha, backend=backend)
        assert_identical(s, sp)
        assert tr.records == trp.records and b == bp
        assert 1 not in set(sp.proc.tolist())
        assert port.schedule_violations(sp, spec_p) == []


@pytest.mark.parametrize("backend", ["scalar", "cuda"])
def test_infeasible_placement_raises_like_reference(backend):
    """Every processor masked: the first winner lands beyond the
    feasibility horizon and both packages name the same task."""
    spec_r = ref.FaultSpec(down_procs=(0, 1, 2))
    inst_r = ref.CompiledInstance(ref.paper_spg(), ref.paper_topology(),
                                  faults=spec_r)
    inst_p = port.CompiledInstance(port.paper_spg(), port.paper_topology(),
                                   faults=port.FaultSpec(down_procs=(0, 1, 2)),
                                   device="cpu")
    with pytest.raises(ref.InfeasibleScheduleError) as er:
        inst_r.schedule(list(range(10)), backend="scalar")
    with pytest.raises(port.InfeasibleScheduleError) as ep:
        inst_p.schedule(list(range(10)), backend=backend)
    assert (ep.value.task, ep.value.eft) == (er.value.task, er.value.eft)


@pytest.mark.parametrize("scan", [True, False])
def test_watchdog_raises_wave_timeout(scan):
    """``CompiledInstance.wave_timeout`` bounds each dispatch (the whole
    plan counts ``len(waves)`` budgets)."""
    g, tg = _case(3)
    _, pi, q = _instances(g, tg)
    pi.wave_timeout = 1e-9
    be = port.CudaBackend(pi, scan=scan)
    with pytest.raises(port.WaveTimeoutError):
        pi.schedule(q, 0.5, backend=be)
    pi.wave_timeout = None
    pi.schedule(q, 0.5, backend=be)

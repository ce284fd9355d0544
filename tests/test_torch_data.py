"""The port's data model against the reference's: SPG, topology, the
TGFF generator, input checks, and the plain-value conversion that
carries an instance from one package to the other.

Inputs come from numpy generators seeded the same way for both
packages; equality is exact.
"""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import convert
from test_backend_equivalence import _case, _link_reuse_topology, _wide


def _same_spg(a, b):
    assert a.n == b.n and a.name == b.name
    assert list(a.edges) == list(b.edges)
    assert np.array_equal(a.weights, b.weights)
    assert a.tpl == b.tpl
    assert a.tpl_proportional_ccr == b.tpl_proportional_ccr
    if a.comp_matrix is None:
        assert b.comp_matrix is None
    else:
        assert np.array_equal(a.comp_matrix, b.comp_matrix)
    assert a.succ == b.succ and a.pred == b.pred
    assert a.topo_order == b.topo_order
    assert np.array_equal(a.depth, b.depth)


def _same_topology(a, b):
    assert a.proc_names == b.proc_names
    assert np.array_equal(a.rates, b.rates)
    assert a.link_speed == b.link_speed
    assert a.routes == b.routes
    assert a.ctml_mode == b.ctml_mode
    assert a.all_links() == b.all_links()
    assert a.link_index() == b.link_index()
    for pair in a.routes:
        assert a.route_speed(*pair) == b.route_speed(*pair)
    for p in range(a.n_procs):
        if (p, (p + 1) % a.n_procs) in a.routes:
            assert a.proc_speed(p) == b.proc_speed(p)


def test_paper_example_equal():
    _same_spg(ref.paper_spg(), port.paper_spg())
    _same_spg(ref.paper_spg(ccr=2.0, comp=ref.PAPER_COMP_EXP5),
              port.paper_spg(ccr=2.0, comp=port.PAPER_COMP_EXP5))
    assert np.array_equal(ref.PAPER_COMP, port.PAPER_COMP)
    assert ref.PAPER_EDGES == port.PAPER_EDGES
    _same_topology(ref.paper_topology(), port.paper_topology())
    _same_topology(ref.paper_topology(rates=(1.0, 0.67, 0.83),
                                      ctml_mode="exact"),
                   port.paper_topology(rates=(1.0, 0.67, 0.83),
                                       ctml_mode="exact"))


@pytest.mark.parametrize("P", [3, 8, 16])
def test_fully_switched_topology_equal(P):
    rng = np.random.default_rng(77)
    rates = rng.uniform(0.6, 1.2, size=P)
    speeds = rng.uniform(0.5, 3.0, size=P)
    _same_topology(ref.fully_switched_topology(P, rates, speeds),
                   port.fully_switched_topology(P, rates, speeds))


@pytest.mark.parametrize("seed", range(0, 200, 10))
def test_random_spg_equal_from_same_seed(seed):
    """The generator consumes the numpy stream identically: the same
    seed gives equal graphs, with and without the out-degree repair."""
    tg_r = ref.paper_topology(rates=(1.0, 0.67, 0.83))
    tg_p = port.paper_topology(rates=(1.0, 0.67, 0.83))
    kw = dict(ccr=[0.1, 1.0, 10.0][seed % 3],
              outdeg_constraint=seed % 20 == 0)
    n = 8 + seed % 40
    a = ref.random_spg(n, np.random.default_rng(seed), tg=tg_r, **kw)
    b = port.random_spg(n, np.random.default_rng(seed), tg=tg_p, **kw)
    _same_spg(a, b)


def test_random_spg_exp7_scale_equal():
    """The 500-task exp7 graph, degree caps (3, 6)."""
    P = 16
    rng = np.random.default_rng(77)
    rates, speeds = rng.uniform(0.6, 1.2, P), rng.uniform(0.5, 3.0, P)
    tg_r = ref.fully_switched_topology(P, rates, speeds)
    tg_p = port.fully_switched_topology(P, rates, speeds)
    mk = dict(ccr=1.0, max_in=3, max_out=6)
    a = ref.random_spg(500, np.random.default_rng(7516), tg=tg_r, **mk)
    b = port.random_spg(500, np.random.default_rng(7516), tg=tg_p, **mk)
    _same_spg(a, b)


def _corpus():
    yield ref.paper_spg(), ref.paper_topology()
    for seed in range(0, 200, 29):
        yield _case(seed)
    yield _wide(8, 3)
    yield _wide(16, 4)
    tg = _link_reuse_topology(4)
    yield ref.random_spg(10, np.random.default_rng(0), ccr=1.0, tg=tg), tg


@pytest.mark.parametrize("k", range(11))
def test_convert_round_trip_loses_nothing(k):
    g, tg = list(_corpus())[k]
    gp = convert.spg_from_arrays(**convert.spg_arrays(g))
    tp = convert.topology_from_arrays(**convert.topology_arrays(tg))
    _same_spg(g, gp)
    _same_topology(tg, tp)
    # and back again: the plain values are a fixed point
    a, b = convert.spg_arrays(g), convert.spg_arrays(gp)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert np.array_equal(a[key], b[key])
        else:
            assert a[key] == b[key]
    assert convert.topology_arrays(tp).keys() == \
        convert.topology_arrays(tg).keys()


def test_input_checks_match():
    """The session-boundary checks reject the same inputs with the same
    messages."""
    tg = ref.paper_topology()
    bad_tg = convert.topology_arrays(tg)
    bad_tg["rates"] = np.array([1.0, 0.0, 1.0])
    with pytest.raises(ValueError) as er:
        ref.Scheduler(ref.Topology(**bad_tg))
    with pytest.raises(ValueError) as ep:
        port.Scheduler(convert.topology_from_arrays(**bad_tg),
                       backend="scalar")
    assert str(er.value) == str(ep.value)
    g = port.paper_spg()
    g.weights[3] = np.nan
    gr = ref.paper_spg()
    gr.weights[3] = np.nan
    with pytest.raises(ValueError) as er:
        ref.Scheduler(ref.paper_topology(), backend="scalar").submit(gr)
    with pytest.raises(ValueError) as ep:
        port.Scheduler(port.paper_topology(), backend="scalar").submit(g)
    assert str(er.value) == str(ep.value)

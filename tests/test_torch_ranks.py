"""The port's ranks, HPRV values, LDET and priority queues against the
reference's: exactly equal matrices and identical queues on the paper
example and a slice of the 200-graph corpus."""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.ranks import rank_matrix_reference
from repro_torch.core import convert
from test_backend_equivalence import _case


def _to_port(g, tg):
    return (convert.spg_from_arrays(**convert.spg_arrays(g)),
            convert.topology_from_arrays(**convert.topology_arrays(tg)))


def _assert_ranks_equal(g, tg):
    gp, tp = _to_port(g, tg)
    r = ref.rank_matrix(g, tg)
    rp = port.rank_matrix(gp, tp)
    assert np.array_equal(r, rp)
    assert np.array_equal(rank_matrix_reference(g, tg), rp)
    assert np.array_equal(ref.hrank(g, tg, r), port.hrank(gp, tp, rp))
    assert np.array_equal(ref.ldet_cc(g, tg, r), port.ldet_cc(gp, tp, rp))
    a, ap = ref.hprv_a(g, tg, r), port.hprv_a(gp, tp, rp)
    assert np.array_equal(a, ap)
    h = r.mean(axis=1)
    assert ref.priority_queue(a, h) == port.priority_queue(ap, h)
    for power in (1, 2):
        for mode in ("indicator", "literal"):
            b = ref.hprv_b(g, tg, r, depth_power=power, outd_mode=mode)
            bp = port.hprv_b(gp, tp, rp, depth_power=power, outd_mode=mode)
            assert np.array_equal(b, bp)
            assert ref.priority_queue(b, h) == port.priority_queue(bp, h)


def test_paper_example_ranks():
    _assert_ranks_equal(ref.paper_spg(), ref.paper_topology())
    # the paper's queue B is n1..n10
    g, tg = port.paper_spg(), port.paper_topology()
    r = port.rank_matrix(g, tg)
    assert port.priority_queue(port.hprv_b(g, tg, r), r.mean(1)) == \
        list(range(10))


@pytest.mark.parametrize("seed", range(0, 200, 5))
def test_corpus_ranks(seed):
    _assert_ranks_equal(*_case(seed))

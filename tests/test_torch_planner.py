"""The port's planner (``repro_torch.planner``) against the JAX
package's (``repro.planner``).

The cost model and the graph builders are plain float arithmetic, the
same in both packages, so every cost, weight, edge volume and query
mapping must be exactly equal, for every architecture.  The GPU cluster
topology must name its processors, links and routes as the reference's
TPU slice topology does for the same cut, with rates and link speeds
from H100 data-sheet peaks.  Placement on a topology carried across
(``core/convert.py``) must equal the reference's scalar backend bit for
bit, on the port's ``device="cpu"`` kernels and on its scalar backend.
"""
import dataclasses

import numpy as np
import pytest

import repro.configs as rcfg
import repro.core as rcore
import repro.planner as R
import repro.planner.cost_model as RC
import repro.planner.placement as RPL
import repro_torch.configs as pcfg
import repro_torch.planner as P
from repro_torch.core import spg_arrays, topology_arrays

ARCHS = sorted(rcfg.ARCHS)
SHAPES = sorted(rcfg.SHAPES)


def _pair(name, shape):
    return (rcfg.get_arch(name), rcfg.SHAPES[shape],
            pcfg.get_arch(name), pcfg.SHAPES[shape])


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:          # compared, not swallowed
        return type(e)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ARCHS)
def test_costs_equal(name, shape):
    """Every cell, defined or not: where the reference raises (an
    encoder's decode has no cache), the port raises the same error."""
    rc, rs, pc, ps = _pair(name, shape)
    assert P.layer_costs(pc, ps) == R.layer_costs(rc, rs)
    assert P.total_flops(pc, ps) == RC.total_flops(rc, rs)
    assert P.model_flops(pc, ps) == RC.model_flops(rc, rs)
    assert _outcome(P.hbm_bytes, pc, ps) == _outcome(RC.hbm_bytes, rc, rs)
    for units in (4, 16):
        assert P.stage_graph_costs(pc, ps, units) == \
            R.stage_graph_costs(rc, rs, units)


def _same_graph(got, want):
    a, b = spg_arrays(got), spg_arrays(want)
    assert np.array_equal(a.pop("weights"), b.pop("weights"))
    assert a == b


@pytest.mark.parametrize("name", ARCHS)
def test_graph_builders_equal(name):
    rc, rs, pc, ps = _pair(name, "decode_32k")
    _same_graph(P.model_stage_graph(pc, ps), R.model_stage_graph(rc, rs))
    _same_graph(P.pipeline_graph(pc, ps, 4, 8), R.pipeline_graph(rc, rs, 4, 8))
    for nq in (1, 2, 5):
        shape = dataclasses.replace(ps, global_batch=4, seq_len=1024)
        rshape = dataclasses.replace(rs, global_batch=4, seq_len=1024)
        got = P.serving_query_graph(pc, shape, n_queries=nq)
        want = R.serving_query_graph(rc, rshape, n_queries=nq)
        _same_graph(got, want)
        assert got.query_ops == want.query_ops


def test_hw_is_the_h100_data_sheet():
    hw = P.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.nvlink_links,
            hw.net_bw, hw.mfu) == (989e12, 3.35e12, 25e9, 18, 50e9, 0.5)


@pytest.mark.parametrize("n_slices,nodes", [(4, 1), (8, 2)])
def test_gpu_topology_names_and_routes_match_the_reference(n_slices, nodes):
    gps = 2
    got = P.gpu_slice_topology(n_slices=n_slices, gpus_per_slice=gps,
                               nodes=nodes, degraded={1: 0.5})
    want = R.tpu_slice_topology(n_slices=n_slices, chips_per_slice=4,
                                pods=nodes)
    a, b = topology_arrays(got), topology_arrays(want)
    assert a["proc_names"] == b["proc_names"]
    assert sorted(a["link_speed"]) == sorted(b["link_speed"])
    assert a["routes"] == b["routes"]
    assert a["ctml_mode"] == b["ctml_mode"]
    hw = P.HW()
    rate = gps * hw.peak_flops * hw.mfu
    assert np.array_equal(a["rates"], [rate * (0.5 if i == 1 else 1.0)
                                       for i in range(n_slices)])
    per_node = n_slices // nodes
    for i in range(n_slices - 1):
        same = i // per_node == (i + 1) // per_node
        assert a["link_speed"][f"l{i}"] == (
            gps * hw.nvlink_links * hw.nvlink_bw if same else gps * hw.net_bw)
    assert a["link_speed"]["dcn"] == gps * hw.net_bw


def _ref_topology(tg):
    return rcore.Topology(**topology_arrays(tg))


@pytest.mark.parametrize("algorithm", ["hsv", "hvlb_a", "hvlb_b"])
@pytest.mark.parametrize("how", [dict(device="cpu"), dict(backend="scalar")],
                         ids=["cpu", "scalar"])
def test_placement_equals_the_reference_scalar_backend(algorithm, how):
    pc, ps = pcfg.get_arch("qwen3-8b"), pcfg.SHAPES["decode_32k"]
    rc, rs = rcfg.get_arch("qwen3-8b"), rcfg.SHAPES["decode_32k"]
    tg = P.gpu_slice_topology(n_slices=8, gpus_per_slice=2, nodes=2,
                              degraded={3: 0.6})
    rtg = _ref_topology(tg)
    g, rg = P.pipeline_graph(pc, ps, 3, 6), R.pipeline_graph(rc, rs, 3, 6)
    # the reference's plan runs on its scalar backend, not a demotion
    assert rcore.Scheduler(rtg, backend="scalar").submit(rg).backend == \
        "scalar"
    got = P.plan_placement(g, tg, algorithm, alpha_max=1.0, **how)
    want = R.plan_placement(rg, rtg, algorithm, alpha_max=1.0,
                            backend="scalar")
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(got.schedule, f),
                              getattr(want.schedule, f)), f
    assert (got.makespan_s, got.load_balance, got.assignment,
            got.stage_map) == (want.makespan_s, want.load_balance,
                               want.assignment, want.stage_map)
    rates = list(tg.rates * np.array([1, 1, 0.7, 1, 1, 1, 1.2, 1]))
    got = P.replan(g, tg, rates, algorithm, **how)
    want = RPL.replan(rg, rtg, rates, algorithm, backend="scalar")
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(got.schedule, f),
                              getattr(want.schedule, f)), f
    assert got.assignment == want.assignment

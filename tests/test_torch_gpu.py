"""The port's kernels on the card, held against their plain versions and
the scalar reference.

Every test here is marked ``gpu`` and skips on a host without CUDA.  The
file imports only the port (no JAX, no reference package), so it runs on
a machine that has the card and PyTorch but not JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro_torch.core.backends import cuda as K

pytestmark = pytest.mark.gpu

RATES = [(1.0, 0.67, 0.83), (0.83, 0.67, 1.0), (0.67, 0.83, 1.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    if kind == "wide":
        P = 16
        tg = port.fully_switched_topology(
            P, rates=rng.uniform(0.6, 1.2, size=P),
            link_speeds=rng.uniform(0.5, 3.0, size=P))
        return port.random_spg(60, rng, ccr=1.0, tg=tg, max_in=3,
                               max_out=6), tg
    P = 4                      # routes that visit one link twice
    tg = port.Topology([f"p{i}" for i in range(P)], np.ones(P),
                       {f"l{i}": 1.0 for i in range(P)},
                       {(a, b): [(f"l{a}", f"l{a}")] for a in range(P)
                        for b in range(a + 1, P)})
    return port.random_spg(10, rng, ccr=1.0, tg=tg), tg


CASES = [("paper", 0), ("case", 0), ("case", 29), ("wide", 3),
         ("reuse", 0)]


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


def test_session_on_card_counts_one_launch(card):
    g, tg = port.paper_spg(), port.paper_topology()
    K.reset_launches()
    plan = port.Scheduler(tg).submit(
        g, port.HVLB_CC_B(alpha_max=3.0, period=150.0))
    assert plan.backend == "cuda"
    assert (plan.makespan, plan.best_alpha) == (62.0, 1.06)
    assert K.LAUNCHES == {"sched_wave_kernel": 0, "sched_plan_kernel": 1}

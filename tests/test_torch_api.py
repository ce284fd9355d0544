"""The port's session API against the reference's and the paper.

``Scheduler(device="cpu")`` runs the default (cuda) backend on the
kernels' plain versions; it must give the paper's pinned numbers and
sweep arrays exactly equal to the reference ``Scheduler(backend=
"scalar")``.  A session that did not ask for the CPU raises on a host
without CUDA, and importing the port pulls in neither JAX nor the
reference package.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import convert
from test_backend_equivalence import _case, assert_identical


def _policies(mod):
    return [mod.HSV_CC(),
            mod.HVLB_CC_A(alpha_max=1.0, alpha_step=0.25, period=150.0),
            mod.HVLB_CC_B(alpha_max=3.0, alpha_step=0.01),
            mod.HVLB_CC_IC(alpha_max=1.0, alpha_step=0.1),
            mod.HVLB_CC_B(alpha_max=2.0, alpha_step=0.05, sweep="adaptive")]


def test_paper_pinned_numbers_on_plain_kernels():
    g, tg = port.paper_spg(), port.paper_topology()
    s = port.Scheduler(tg, device="cpu")
    hsv = s.submit(g, port.HSV_CC())
    hv = s.submit(g, port.HVLB_CC_B(alpha_max=3.0, period=150.0))
    ic = s.submit(g, port.HVLB_CC_IC(alpha_max=3.0, period=150.0))
    assert (hsv.backend, hv.backend, ic.backend) == ("cuda",) * 3
    assert hsv.makespan == 73.0
    assert hv.makespan == 62.0 and hv.best_alpha == 1.06
    assert sorted(set(hv.proc.tolist())) == [0, 1, 2]
    assert {t: h for t, h in ic.holes.items() if np.isfinite(h)} == \
        {0: 1.0, 5: 4.0}
    ric = ref.Scheduler(ref.paper_topology(), backend="scalar").submit(
        ref.paper_spg(), ref.HVLB_CC_IC(alpha_max=3.0, period=150.0))
    for t in ic.holes:
        for lam in (0.5, 2.0, 100.0):
            assert ic.precision(t, lam) == ric.precision(t, lam)
    # the fused grid ran all 301 alphas in one dispatch
    be = s._sessions[id(g)].inst.backend_instance("cuda")
    assert be.n_launches == 3 and be.n_roundtrips == 3


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("backend", ["cuda", "scalar"])
def test_sweep_arrays_equal_reference_scalar(k, backend):
    g, tg = ref.paper_spg(), ref.paper_topology()
    gp = convert.spg_from_arrays(**convert.spg_arrays(g))
    tp = convert.topology_from_arrays(**convert.topology_arrays(tg))
    pr = ref.Scheduler(tg, backend="scalar").submit(g, _policies(ref)[k])
    pp = port.Scheduler(tp, backend=backend, device="cpu").submit(
        gp, _policies(port)[k])
    assert pp.backend == backend
    assert_identical(pr.schedule, pp.schedule)
    assert pr.period == pp.period
    if pr.sweep is not None:
        assert np.array_equal(pr.sweep.alphas, pp.sweep.alphas)
        assert np.array_equal(pr.sweep.makespans, pp.sweep.makespans)
        assert pr.sweep.best_alpha == pp.sweep.best_alpha
    assert pr.holes == pp.holes
    if backend == "scalar" or pr.sweep is None \
            or _policies(ref)[k].sweep != "grid":
        # the host loop skips the same alphas as the reference's
        assert dataclasses.asdict(pr.replay) == dataclasses.asdict(pp.replay)


@pytest.mark.parametrize("seed", [3, 40, 77])
def test_corpus_sweeps_equal_reference_scalar(seed):
    g, tg = _case(seed)
    gp = convert.spg_from_arrays(**convert.spg_arrays(g))
    tp = convert.topology_from_arrays(**convert.topology_arrays(tg))
    pol = dict(alpha_max=1.5, alpha_step=0.05, period=200.0)
    pr = ref.Scheduler(tg, backend="scalar").submit(g, ref.HVLB_CC_B(**pol))
    pp = port.Scheduler(tp, device="cpu").submit(gp, port.HVLB_CC_B(**pol))
    assert_identical(pr.schedule, pp.schedule)
    assert np.array_equal(pr.sweep.makespans, pp.sweep.makespans)
    assert pr.sweep.best_alpha == pp.sweep.best_alpha


def test_default_session_needs_the_card(monkeypatch):
    """Without CUDA, a session that did not ask for the CPU raises — at
    construction and on a per-call override — and never runs on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg, g = port.paper_topology(), port.paper_spg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Scheduler(tg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Scheduler(tg, backend="cuda", device="cuda")
    s = port.Scheduler(tg, backend="scalar")
    assert s.submit(g, port.HSV_CC()).makespan == 73.0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.submit(g, port.HSV_CC(), backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.CudaBackend(port.CompiledInstance(g, tg))


def test_invalid_arguments_rejected():
    tg = port.paper_topology()
    with pytest.raises(ValueError, match="unknown backend"):
        port.Scheduler(tg, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="batch"):
        port.Scheduler(tg, batch=0, device="cpu")
    with pytest.raises(ValueError, match="device must be"):
        port.Scheduler(tg, device="meta")
    with pytest.raises(ValueError, match="unknown sweep"):
        port.Scheduler(tg, device="cpu").submit(
            port.paper_spg(), port.HVLB_CC_B(sweep="nope"))


def test_batch_cap_is_decision_invariant():
    g, tg = port.paper_spg(), port.paper_topology()
    pol = port.HVLB_CC_B(alpha_max=1.5, alpha_step=0.1, period=150.0)
    plans = [port.Scheduler(tg, device="cpu", batch=b).submit(g, pol)
             for b in (1, 3, 16)]
    for p in plans[1:]:
        assert_identical(plans[0].schedule, p.schedule)
        assert np.array_equal(plans[0].sweep.makespans, p.sweep.makespans)
    assert [p.batch for p in plans] == [1, 3, 16]


def test_import_pulls_in_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.core.backends.cuda, repro_torch.configs, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.flash_attention.kernel, "
            "repro_torch.kernels.flash_attention.ref, "
            "repro_torch.kernels.ssm_scan.ops, "
            "repro_torch.kernels.ssm_scan.kernel, "
            "repro_torch.kernels.ssm_scan.ref, repro_torch.service, "
            "repro_torch.service.__main__, repro_torch.core.metrics, "
            "repro_torch.core.hsv_cc, repro_torch.core.hvlb_cc\n"
            "bad = sorted(m for m in sys.modules if m == 'repro' or "
            "m.startswith(('repro.', 'jax', 'jaxlib')))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

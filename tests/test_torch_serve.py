"""The port's DSMS serving engine (``repro_torch.serve.DSMSEngine``) and
its launcher against the JAX package's (``repro.serve``), in f32 on the
CPU.

Both engines get the same weights (the reference's, carried across by
``params_from_jax``) and schedule on the same topology: the port's
default one-node GPU topology, carried into the reference with
``core/convert.py``, where the reference runs its scalar backend and the
port its kernels' plain versions (``device="cpu"``).  Plans and holes
must be equal bit for bit, after every replan; each step's tokens must
be equal, its query outputs within 1e-5 (``|got - want| <= tol + tol *
|want|``; top-k by value, since ties may order indices differently) and
its ``precise`` / ``precision`` equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.core as rcore
import repro.serve as RS
import repro_torch.configs as pcfg
import repro_torch.serve as PS
from repro.models import params as RP
from repro_torch.core import topology_arrays
from repro_torch.launch.serve import default_queries
from repro_torch.models import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
BATCH, MAX_SEQ = 2, 8


def _ref_queries():
    """The port launcher's queries, in JAX."""
    return [
        RS.Query("argmax_conf",
                 mandatory=lambda lg: jnp.max(jax.nn.softmax(lg[:, -1]), -1)),
        RS.Query("topk", mandatory=lambda lg: jax.lax.top_k(lg[:, -1], 5),
                 optional=lambda r: (r[0], r[1], jnp.sort(r[0])[..., ::-1]),
                 optional_ratio=0.5),
    ]


def _engines(name="qwen2-0.5b", queries=True):
    """The reference's and the port's engine on the same weights and
    topology, f32, each with the launcher's two queries."""
    rc = dataclasses.replace(rcfg.reduced_config(rcfg.get_arch(name)),
                             dtype="float32")
    pc = dataclasses.replace(pcfg.reduced_config(pcfg.get_arch(name)),
                             dtype="float32")
    weights = RP.init_params(rc, jax.random.PRNGKey(0))
    ref = RS.DSMSEngine(rc, weights, BATCH, MAX_SEQ, backend="scalar")
    port = PS.DSMSEngine(pc, params_from_jax(
        jax.tree.map(np.asarray, weights), "cpu"), BATCH, MAX_SEQ,
        device="cpu")
    ref.topology = rcore.Topology(**topology_arrays(port.topology))
    ref.scheduler = rcore.Scheduler(
        ref.topology, policy=rcore.HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1),
        backend="scalar")
    if queries:
        for q in _ref_queries():
            ref.register(q)
        for q in default_queries():
            port.register(q)
    return ref, port


def _same_plan(ref, port):
    assert port._query_nodes == ref._query_nodes
    assert port.replans == ref.replans
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(port.plan, f), getattr(ref.plan, f)), f
    assert port.holes == ref.holes
    # the reference planned on its scalar backend, the port on its kernels'
    # plain versions
    assert ref.scheduler.submit(ref._graph).backend == "scalar"
    assert port.scheduler.submit(port._graph).backend == "cuda"


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _same_step(ref, port, toks):
    want, got = ref.step(toks), port.step(toks)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.query_outputs["argmax_conf"],
           want.query_outputs["argmax_conf"])
    g, w = got.query_outputs["topk"], want.query_outputs["topk"]
    assert len(g) == len(w)
    _close(g[0], w[0])
    if len(g) == 3:                      # the refinement ran
        _close(g[2], w[2])
    assert got.precise == want.precise
    assert got.precision == want.precision
    return got.tokens


def test_dsms_engine_lazy_replan_counts():
    """Registering Q queries costs one re-plan (on first use), not Q (the
    reference's ``test_dsms_engine_lazy_replan_counts``)."""
    _, eng = _engines(queries=False)
    for k in range(3):
        eng.register(PS.Query(f"q{k}",
                              mandatory=lambda lg: lg.max(dim=-1).values))
    assert eng.replans == 0 and eng.plan is None
    eng.ensure_plan()
    assert eng.replans == 1
    eng.ensure_plan()                       # clean -> no extra replan
    assert eng.replans == 1
    g = eng._graph
    assert set(eng._query_nodes.values()) == \
        {g.query_ops[qi][0] for qi in range(3)}
    assert all(g.pred[n] for n in eng._query_nodes.values())
    eng.register(PS.Query("late", mandatory=lambda lg: lg.min(dim=-1).values))
    assert eng.replans == 1                 # still lazy
    res = eng.step(np.zeros(BATCH, np.int64))   # first step replans
    assert eng.replans == 2
    assert set(res.query_outputs) == {"q0", "q1", "q2", "late"}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-8b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_plan_and_steps_equal_reference(name):
    ref, port = _engines(name)
    ref.ensure_plan()
    port.ensure_plan()
    _same_plan(ref, port)
    toks = np.zeros(BATCH, np.int64)
    for _ in range(4):
        toks = _same_step(ref, port, toks)
    assert port.pos == ref.pos == 4
    _same_plan(ref, port)                   # stepping never replans


def _hub(eng):
    return eng._graph.pred[eng._query_nodes[0]][0]


EVENTS = {
    "retime": lambda e: e.retime({_hub(e): 1.3}),
    "retime_batch": lambda e: e.retime([{_hub(e): 1.3}, {1: 0.8}]),
    "mark_failed_proc": lambda e: e.mark_failed(proc=3),
    "mark_failed_link": lambda e: e.mark_failed(link="l1"),
    "degrade_link": lambda e: e.degrade(link="l0", factor=2.0),
    "degrade_task": lambda e: e.degrade(task=_hub(e), factor=1.5),
    "fail_then_restore": lambda e: (e.mark_failed(proc=0),
                                    e.restore(proc=0)),
}


@pytest.mark.parametrize("event", sorted(EVENTS))
def test_replans_equal_reference(event):
    ref, port = _engines()
    toks = _same_step(ref, port, np.zeros(BATCH, np.int64))
    EVENTS[event](ref)
    EVENTS[event](port)
    _same_plan(ref, port)
    pf, rf = port.scheduler.faults, ref.scheduler.faults
    assert (pf.down_procs, pf.link_factors) == \
        (rf.down_procs, rf.link_factors)
    _same_step(ref, port, toks)


def _launch(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--reduced", "--device", "cpu", "--steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "2 registered queries" in out.stdout
    assert "2 steps" in out.stdout


def test_launcher_runs_on_the_cpu():
    _launch("qwen2-0.5b")


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "dbrx-132b"])
def test_launcher_serves_every_family_on_the_cpu(name):
    _launch(name)


def test_launcher_refuses_the_encoder():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hubert-xlarge", "--reduced", "--device", "cpu", "--steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "encoder-only" in out.stderr


def test_engine_defaults_to_the_card():
    """No device given: the engine runs on the card, and a host without
    one refuses instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pc = pcfg.reduced_config(pcfg.get_arch("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.DSMSEngine(pc, {}, BATCH, MAX_SEQ)

"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU, against the reference's ``examples/``.

* **quickstart**: every line of sections 1-5 (HSV_CC 73.0, HVLB_CC(B)
  62.0 at alpha 1.06, the holes ``{n1: 1.0, n6: 4.0}``, the drift line)
  equals the reference quickstart's output, run in this process; section
  7's device backend plans 62.0 at 1.06 in float64 and in float32 with
  the same placements.
* **dsms_serve**: the serving plan's makespan and holes equal the
  reference ``DSMSEngine``'s plan for the same config on the same
  topology (no reference decode is needed), the service lines equal the
  reference service's on the same calls, and the decode outputs are
  finite tokens of the vocabulary.
* **train_lm**: 4 steps saving every 2, then a restart from the step-2
  checkpoint: the resumed steps' losses equal the uninterrupted run's bit
  for bit.
"""
import asyncio
import contextlib
import io
import math
import runpy
import shutil
import warnings
from pathlib import Path

import jax
import numpy as np

import repro.configs as rcfg
import repro.core as rcore
import repro.serve as RS
import repro.service as RSV
from repro.models import params as RP
from repro_torch.core import topology_arrays
from repro_torch.examples import dsms_serve, quickstart, train_lm

ROOT = Path(__file__).resolve().parents[1]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().splitlines()


def test_quickstart_lines_equal_the_reference():
    out, lines = _run(quickstart.main, ["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        # its section 7 demotes the pallas backend with a warning
        warnings.simplefilter("ignore")
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    want = buf.getvalue().splitlines()
    n = next(i for i, ln in enumerate(want) if ln.startswith("after drift"))
    assert lines[:n + 1] == want[:n + 1]
    assert lines[0].startswith("HSV_CC   makespan= 73.0")
    assert any(ln.startswith("HVLB_CC(B) makespan= 62.0 (alpha=1.06)")
               for ln in lines)
    assert any(ln.startswith("schedule holes: {'n1': 1.0, 'n6': 4.0,")
               for ln in lines)
    assert lines[-1] == want[-1]
    f64, f32 = out["device"]["torch.float64"], out["device"]["torch.float32"]
    for pp in (f64, f32):
        assert pp.backend == "cuda"
        assert (pp.makespan, pp.best_alpha) == (62.0, 1.06)
    assert np.array_equal(f64.schedule.proc, f32.schedule.proc)
    assert np.array_equal(f64.schedule.proc, out["hvlb"].schedule.proc)


async def _reference_service_lines():
    """The reference example's service quickstart, its lines."""
    tg = rcore.fully_switched_topology(4, rates=[1.0, 1.1, 0.9, 1.2],
                                       link_speeds=[1.0, 1.5, 0.9, 1.2])
    svc = RSV.SchedulerService(tg, workers=2)
    car = svc.client("carA")
    rng = np.random.default_rng(0)
    graphs = [rcore.random_spg(10, rng, tg=tg) for _ in range(3)]
    resps = await asyncio.gather(*[
        asyncio.ensure_future(car.register(g, name=f"q{k}"))
        for k, g in enumerate(graphs)])
    lines = [f"service: registered {len(resps)} query graphs with "
             f"{svc.stats.replans} replan; fleet makespan="
             f"{resps[0].result['makespan']:.3f}"]
    resps = await asyncio.gather(
        asyncio.ensure_future(car.update(task_rates={2: 1.5}, graph="q0")),
        asyncio.ensure_future(car.update(task_rates={4: 0.8}, graph="q1")))
    lines.append(f"service: 2 drift updates folded into "
                 f"{resps[0].result['replay']['coalesced']}-event replay "
                 f"({svc.stats.replans} replans total)")
    resp = await car.mark_failed(proc=3)
    lines.append(f"service: proc 3 down -> ok={resp.ok}, "
                 f"makespan={resp.result['makespan']:.3f}, "
                 f"faults={resp.result['faults']}")
    return lines


def test_dsms_serve_plan_and_service_equal_the_reference():
    out, lines = _run(dsms_serve.main, ["--device", "cpu", "--steps", "2"])
    eng = out["engine"]
    # the reference engine on the same config, queries and topology (its
    # scalar backend); planning needs no decode
    rc = rcfg.reduced_config(rcfg.get_arch("qwen3-8b"))
    ref = RS.DSMSEngine(rc, RP.init_params(rc, jax.random.PRNGKey(0)),
                        batch_size=4, max_seq=64)
    ref.topology = rcore.Topology(**topology_arrays(eng.topology))
    ref.scheduler = rcore.Scheduler(
        ref.topology, policy=rcore.HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1),
        backend="scalar")
    for q in dsms_serve.queries():
        ref.register(RS.Query(q.name, mandatory=q.mandatory,
                              optional=q.optional,
                              optional_ratio=q.optional_ratio))
    ref.ensure_plan()
    assert eng.plan.makespan == ref.plan.makespan
    assert eng.holes == ref.holes
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(eng.plan, f), getattr(ref.plan, f))
    assert lines[0] == (f"engine: 3 queries, 1 replan; plan makespan="
                        f"{ref.plan.makespan * 1e3:.3f} ms on "
                        f"{ref.topology.n_procs} slices")
    assert lines[1] == (f"holes: "
                        f"{ {k: round(v*1e3, 3) for k, v in ref.holes.items()} }"
                        f" (ms)")
    # decode: finite outputs, tokens of the vocabulary
    assert len(out["steps"]) == 2
    for res in out["steps"]:
        assert all(0 <= t < eng.cfg.vocab for t in res.tokens.tolist())
        for name, v in res.query_outputs.items():
            for x in (v if isinstance(v, tuple) else (v,)):
                assert bool(x.float().isfinite().all()), name
    i = lines.index("done.")
    assert lines[i + 1:i + 4] == asyncio.run(_reference_service_lines())
    assert lines[-1] == "service quickstart done."


def test_train_lm_resume_equals_the_straight_run(tmp_path):
    base = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
            "--d-model", "64", "--layers", "2", "--seq", "32",
            "--batch", "2"]
    straight, lines = _run(train_lm.main,
                           base + ["--ckpt", str(tmp_path / "a")])
    assert len(straight) == 4 and all(math.isfinite(x) for x in straight)
    assert lines[-1] == "done."
    assert "  checkpoint @ 2" in lines and "  checkpoint @ 4" in lines
    # an interrupted run: only the step-2 checkpoint was written
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    resumed, lines = _run(train_lm.main, base + ["--ckpt",
                                                 str(tmp_path / "b"),
                                                 "--resume"])
    assert lines[0] == "resumed from step 2"
    assert resumed == straight[2:]

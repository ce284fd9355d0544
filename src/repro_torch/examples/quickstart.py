"""Quickstart: the paper's scheduler end to end through the session API,
the twin of the reference's ``examples/quickstart.py``.  On the card::

    PYTHONPATH=src python -m repro_torch.examples.quickstart

and on the CPU, where the device backend runs its kernels' plain
PyTorch versions::

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

A host without a card stops before the first section unless it is given
``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..core import (HSV_CC, HVLB_CC_B, HVLB_CC_IC, Scheduler, load_balance,
                    paper_spg, paper_topology, slr, speedup)
from ..core.backends.cuda import check_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the quickstart; returns its plans by name."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device backend of section 7 runs")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    # 1. The paper's worked example: Fig. 3 graph on the Fig. 2 network,
    #    submitted to a long-lived scheduler session (register once,
    #    execute continuously — the DSMS loop).  backend= selects the
    #    candidate-evaluation backend: "auto" runs the scalar loop on
    #    small topologies and the (P,)-batch vector backend from P >= 8
    #    — all host backends are bit-identical, it is purely a speed knob.
    g = paper_spg()
    tg = paper_topology()
    sched = Scheduler(tg, backend="auto")       # one session, shared compile

    # 2. Baseline HSV_CC (Xie et al.) — tasks pile onto the fast processors.
    hsv = sched.submit(g, HSV_CC()).schedule
    print(f"HSV_CC   makespan={hsv.makespan:5.1f}  SLR={slr(hsv):.2f} "
          f"speedup={speedup(hsv):.2f}  LB={load_balance(hsv):.2f}")
    for p in range(3):
        tasks = [f"n{i+1}" for i in hsv.tasks_on(p)]
        print(f"  p{p+1}: {tasks}")

    # 3. HVLB_CC — load-balanced, contention-aware (Algorithm 1 alpha
    #    sweep).
    plan = sched.submit(g, HVLB_CC_B(alpha_max=3.0, period=150.0))
    best = plan.schedule
    print(f"\nHVLB_CC(B) makespan={best.makespan:5.1f} "
          f"(alpha={plan.best_alpha:.2f}) SLR={slr(best):.2f} "
          f"speedup={speedup(best):.2f} LB={load_balance(best):.2f}")
    for p in range(3):
        tasks = [f"n{i+1}" for i in best.tasks_on(p)]
        print(f"  p{p+1}: {tasks}")
    # the sweep curve ships as plotting-ready arrays (Fig. 5)
    print(f"sweep: {len(plan.sweep.alphas)} grid points, "
          f"makespan range [{plan.sweep.makespans.min():.0f}, "
          f"{plan.sweep.makespans.max():.0f}]")

    # 4. Imprecise computation as a first-class policy (Section 4.4): the
    #    plan carries its schedule holes and precision accessors directly.
    ic = sched.submit(g, HVLB_CC_IC(alpha_max=3.0, period=150.0))
    print("\nschedule holes:", {f"n{k+1}": round(v, 1)
                                for k, v in ic.holes.items()})

    # 5. Online drift (Section 4.4): task n10's arrival rate drops 10%.
    #    probe_update reports how much of the memoized decision trace
    #    survives (rank recomputation only); update() then re-simulates
    #    just that suffix, bit-identical to a fresh plan.  In this 10-task
    #    example the drift reaches every ancestor rank so the whole trace
    #    re-runs.
    b_policy = HVLB_CC_B(alpha_max=3.0, period=150.0)
    surviving = sched.probe_update(task_rates={9: 0.9}, policy=b_policy)
    upd = sched.update(task_rates={9: 0.9}, policy=b_policy)
    print(f"\nafter drift: makespan={upd.makespan:.1f}; probe said "
          f"{surviving}/{g.n} decisions survive, update replayed "
          f"{upd.replay.decisions_replayed} and re-simulated "
          f"{upd.replay.decisions_simulated}")

    # 6. Wide clusters: on P >= 8 processors "auto" resolves to the
    #    vectorized backend; the plan records which numeric layer ran.
    #    An explicit override is per-call: sched.submit(g,
    #    backend="scalar").
    print(f"\nbackend on this 3-processor example: {upd.backend} "
          "(vector kicks in from P >= 8; backend='cuda', the default, "
          "runs the device kernels)")

    # 7. The device backend (the session default): the whole HVLB_CC grid
    #    in one sched_plan_kernel launch on the card, every alpha at once
    #    (its kernels' plain versions with --device cpu).  Its float64
    #    mode is bit-identical to the host backends above; dtype=
    #    torch.float32 runs the reference's TPU numerics.
    device = {}
    for dtype in (torch.float64, torch.float32):
        pp = Scheduler(tg, device=dev, dtype=dtype).submit(
            g, HVLB_CC_B(alpha_max=3.0, period=150.0))
        device[str(dtype)] = pp
        print(f"cuda on {dev.type} ({str(dtype)[6:]}, "
              f"{len(pp.sweep.alphas)} alphas in one dispatch): "
              f"makespan={pp.makespan:.1f} at alpha={pp.best_alpha:.2f}")
    # (the band is the backend's F32_NEAR_TIE_RTOL, which no code reads)
    print("float32 near-tie policy: decisions equal float64's unless two "
          "candidates' values (or two routes' LFTs) differ by less than "
          "1e-05 relative; then the float32 argmin decides, first index on "
          "exact ties")

    print("\n(paper: HSV_CC=73, HVLB_CC=62 — see tests/test_paper_example.py)")
    return {"hsv": hsv, "hvlb": plan, "ic": ic, "drift": upd,
            "device": device}


if __name__ == "__main__":
    main()

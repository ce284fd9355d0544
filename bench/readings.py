"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, a run of ``--steps`` steps (the cell's traffic at
the cell's size) and its compared numbers, and with ``--control`` the
control's numbers on the same tuples (the f32 reference with every
product in fp8 put in the program's place), and with ``--plan-control``
the plans of the program's float32 scheduler against the reference's.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --steps 500 [--control] [--plan-control]
    python3 bench/readings.py --config <name> --traffic <mix> ...

One JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def plan_control(run) -> float:
    """Plans of the program's float32 scheduler (its near-tie mode) on the
    run's first stream set's graphs and drift events, counted where they
    differ from the reference's."""
    import torch
    from bench.harness import same_plan
    from bench.reference import plan as PR
    from repro_torch.core import HVLB_CC_IC, Scheduler
    from repro_torch.planner import gpu_slice_topology, serving_query_graph
    from repro_torch.configs import SHAPES
    import dataclasses
    tg = gpu_slice_topology(n_slices=4, gpus_per_slice=2, nodes=1)
    sched = Scheduler(tg, policy=HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1),
                      device=run.dev, dtype=torch.float32)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=run.B,
                                seq_len=run.life)
    g = serving_query_graph(run.mcfg, shape,
                            n_queries=run.spec["queries"]["count"])
    seg = run.segments[0]
    sess = PR.Session(run.graph0, PR.slice_topology())
    p = sched.submit(g)
    plans = [(p.schedule.proc, p.schedule.start, p.schedule.finish,
              p.holes)]
    refs = [sess.current]
    for ev in seg.events:
        p = sched.update(task_rates=ev, graph=p.graph)
        plans.append((p.schedule.proc, p.schedule.start, p.schedule.finish,
                      p.holes))
        refs.append(sess.drift(ev))
    return float(sum(not same_plan(a, b) for a, b in zip(plans, refs)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--config", help="a configuration file's name, with "
                    "--traffic, in place of --workload")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--plan-control", action="store_true")
    args = ap.parse_args()
    import torch
    from bench.harness import Run, files_cell, load_cell
    cell = load_cell(args.workload) if args.workload \
        else files_cell(args.config, args.traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell, seed, 0, False, steps=args.steps)
        run.setup()
        run.window()
        t1 = time.perf_counter()
        out = {"workload": cell.name, "seed": seed, "steps": len(run.steps),
               "setup_s": run.setup_s, "build_peak": run.build_peak,
               "memory_peak": run.memory_peak,
               "step_ms_mean": sum(s.ms for s in run.steps) / len(run.steps),
               "program": run.check(), "check_s": time.perf_counter() - t1}
        if args.control:
            t2 = time.perf_counter()
            out["control"] = run.control()
            out["control_s"] = time.perf_counter() - t2
        if args.plan_control:
            out["control_plans_differing"] = plan_control(run)
        out["card"] = torch.cuda.get_device_name(0)
        out["total_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device-busy share of one ``Scheduler.submit`` at the exp7 deployment
(16 ECUs, 500 tasks, the 301-alpha HVLB_CC grid), from a torch.profiler
trace of the card.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/trace_submit.py [--out chiprun_out/trace_submit.json]

It builds the kernels, times one submit on a fresh ``Scheduler`` without
the profiler, then profiles one more submit on another fresh
``Scheduler``.  It prints one JSON line: both wall times, the device-busy
time (the union of the kernel, memcpy and memset intervals of the trace)
split by category, the kernels seen, and the device's idle share of the
profiled submit.  The Chrome trace is written to ``--out``.  Without a
CUDA device, or when the trace holds no device activity, it exits with
a code other than 0.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from chip_smoke import EXP7_POLICY, exp7_instance  # noqa: E402
from repro_torch.core import Scheduler  # noqa: E402
from repro_torch.core.backends import cuda as K  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(events) -> float:
    """Length of the union of ``[ts, ts + dur)`` over ``events``."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def timed_submit(g, tg):
    sched = Scheduler(tg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sched.submit(g, EXP7_POLICY)
    torch.cuda.synchronize()
    return plan, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace_submit.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_submit: no CUDA device", file=sys.stderr)
        return 2
    K.build_library()
    g, tg = exp7_instance()
    plan, wall_s = timed_submit(g, tg)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        plan_p, wall_prof_s = timed_submit(g, tg)
    assert plan_p.backend == "cuda" and plan_p.makespan == plan.makespan
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = [e for e in json.loads(out.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError("the trace holds no device activity")
    by_cat = {c: busy_us([e for e in events if e["cat"] == c]) / 1e6
              for c in DEVICE_CATS}
    kernels = {}
    for e in events:
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    busy_s = busy_us(events) / 1e6
    print(json.dumps({
        "phase": "trace_submit", "device": torch.cuda.get_device_name(0),
        "makespan": plan_p.makespan, "submit_s": wall_s,
        "profiled_submit_s": wall_prof_s, "device_busy_s": busy_s,
        "busy_by_category_s": by_cat, "kernels": kernels,
        "idle_share": 1.0 - busy_s / wall_prof_s, "trace": str(out)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

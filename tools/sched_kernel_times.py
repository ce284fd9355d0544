#!/usr/bin/env python3
"""Times the two scheduling kernels of a checkout of the port at the exp7
deployment, three ways, so that two checkouts can be compared on one
card in one run.

    python3 tools/sched_kernel_times.py [--root CHECKOUT] [--reps N]

``--root`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: the one holding this script); its kernels are built there.
The deployment, its queue and the two event timers are this checkout's
``chip_smoke.py`` (exp7: 16 ECUs, 500 tasks, HVLB_CC's 301-alpha grid,
the level waves of its priority queue), imported after the timed
package, so that its imports of ``repro_torch`` resolve to that
package.  For ``sched_wave_kernel``
(wave 16 of the plan, staged after the backend has committed waves
0-15) and ``sched_plan_kernel`` (the whole plan under every alpha) it
prints one JSON line:

* ``wrapper_ms``: CUDA events around back-to-back wrapper calls
  (``chip_smoke.event_ms``, what ``chip_smoke.py`` reports as ``ms``);
  host-bound where the wrapper's host time exceeds the kernel's;
* ``device_ms``: the same calls with the host's enqueue hidden behind a
  spin kernel (``chip_smoke.device_ms``): the device's work per call;
* ``kernel_ms``: the mean duration of the kernel alone over the
  launches a ``torch.profiler`` trace of the same calls holds
  (``kernel_traced`` of them; the trace may drop one);

each with its ``us_per_decision`` (spread over the blocks running in
parallel), for the plan also ``us_per_decision_in_series`` (over the
W * B decisions of one block), and the card's name and power limit.
``--rows-ab N`` adds ``exp7_plan_rows``: the plan kernel timed N times
in turns with the carried AFT / placement rows in shared memory (the
layout the wrapper picks) and in global memory (``ROWS_SMEM_MAX`` set
to 0).  Without a CUDA device it exits with 2.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def kernel_ms(fn, reps: int, name: str) -> tuple:
    """Mean duration of the kernels named ``name`` in a profiler trace
    of ``reps`` calls, and how many launches the trace holds."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    durs = [e["dur"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and name in e["name"]]
    if not durs:
        raise RuntimeError(f"no {name} launch in the trace")
    return sum(durs) / len(durs) / 1e3, len(durs)


def times(cs, fn, reps: int, name: str, decisions: int,
          in_series: int = 0) -> dict:
    k_ms, traced = kernel_ms(fn, reps, name)
    ms = {"wrapper_ms": cs.event_ms(fn, reps),
          "device_ms": cs.device_ms(fn, reps), "kernel_ms": k_ms}
    out = dict(ms)
    for suffix, n in (("_us_per_decision", decisions),
                      ("_us_per_decision_in_series", in_series)):
        out.update({k.replace("_ms", suffix): v * 1e3 / n
                    for k, v in ms.items() if n})
    return {**out, "kernel_traced": traced}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows-ab", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sched_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch.core as port
    from repro_torch.core.backends import cuda as K
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    assert Path(cs.K.__file__).resolve().is_relative_to(root), cs.K.__file__
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    K.build_library()
    g, tg = cs.exp7_instance()
    r, q = cs.queue_of(g, tg)
    inst = port.CompiledInstance(g, tg, rank=r)
    waves = port.plan_waves(q, [list(g.pred[j]) for j in range(g.n)],
                            port.DEFAULT_BATCH_MAX)
    wave_be = port.CudaBackend(inst, scan=False)
    wave_be.start(1.0, g.default_period(tg.rates, tg.n_procs), True)
    for js in waves[:16]:
        wave_be.evaluate_batch(js)
    wargs = wave_be.stage_wave(waves[16], True)
    grid = [k * 0.01 for k in range(301)]
    plan_be = port.CudaBackend(inst)
    plan_be.start(grid[0], g.default_period(tg.rates, tg.n_procs), True)
    pargs = plan_be.stage_plan(waves, grid)
    W, B = pargs["task"].shape
    B16 = len(waves[16])
    rows_ab = {"on_chip": [], "global": []}
    plan = lambda: K.sched_plan(**pargs)
    flat = lambda r: r[0].tensors() + r[1] + r[2:]
    for i in range(args.rows_ab):
        for where, limit in (("on_chip", K.ROWS_SMEM_MAX), ("global", 0)):
            saved, K.ROWS_SMEM_MAX = K.ROWS_SMEM_MAX, limit
            lay = K.launch_layout(pargs["T"], pargs["pred"].shape[2], B, g.n)
            assert (lay.rows == g.n) == (where == "on_chip"), lay
            if i == 0:
                outs = flat(plan())
                ref = outs if where == "on_chip" else ref
                assert all(torch.equal(x, y) for x, y in zip(outs, ref))
            rows_ab[where].append({
                "smem": lay.smem, **times(cs, plan, args.reps,
                                          "sched_plan_kernel",
                                          len(grid) * W * B, W * B)})
            K.ROWS_SMEM_MAX = saved
    print(json.dumps({
        "tool": "sched_kernel_times", "root": str(root), "card": smi,
        "torch": torch.__version__,
        "exp7_wave": {"B": B16, **times(cs, lambda: K.sched_wave(**wargs),
                                        max(args.reps, 50),
                                        "sched_wave_kernel", B16)},
        "exp7_plan": {"A": len(grid), "W": W, "B": B,
                      **times(cs, lambda: K.sched_plan(**pargs), args.reps,
                              "sched_plan_kernel", len(grid) * W * B,
                              W * B)},
        **({"exp7_plan_rows": rows_ab} if args.rows_ab else {})}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

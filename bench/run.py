"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones (``bench/metrics/<name>.py``) from a
profiled span of the same window.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit (also the last lines of standard error).
Without the program (``src/repro_torch``), without a CUDA card, or with
a JAX module loaded once the window has closed, it exits non-zero and
prints no result.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)
sys.path.insert(0, str(ROOT))


def process_age_s() -> float:
    """Seconds from this process's start to now, from /proc (0 where it
    cannot be read)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age_s()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no program to measure: src/repro_torch is not in this "
              "checkout", file=sys.stderr)
        return 4
    import torch
    from bench.harness import Run, load_cell, result

    cell = load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload}: needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              started=STARTED - AGE_AT_START)
    run.setup()
    run.window()
    if run.jax:
        print(f"JAX modules loaded in the measuring process: {run.jax}",
              file=sys.stderr)
        return 3
    t_check = time.perf_counter()
    nums = run.check()
    t_check = time.perf_counter() - t_check

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    log(f"cell {cell.name} seed {args.seed}: setup_s {run.setup_s} "
        f"(build peak {run.build_peak} B), window {run.window_s} s, "
        f"{len(run.steps)} steps, {len(run.replan_ms)} replans, "
        f"{len(run.segments)} stream set(s), peak {run.memory_peak} B, "
        f"check {t_check} s; set-up parts {run.setup_parts}")
    res = result(run, nums)
    if getattr(run, "mfu_bound_by", None):
        log(f"mfu: steps bound by {run.mfu_bound_by} (the data sheet's "
            f"peaks at 700 W)")
    for name, value in nums.items():
        if name not in res["checks"]:
            log(f"reading {name} {value!r} (not compared)")
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The first call of each of torch's CPU vector-math functions in a fresh
process, made from several threads at once as the holds' CPU sides make
it, held against the same call made again and against the C library.

    python3 tools/vml_first_call.py [--processes N] [--seconds S]
                                    [--at-once P] [--threads T]
                                    [--chunks K] [--out PATH]

On the CPU torch computes an f32 or f64 ``cos``, ``sin``, ``exp``,
``log``, ``sqrt`` or ``tanh`` with MKL's vector math (VML), in chunks of
2048 elements, one a thread.  Each process, a fresh interpreter, runs one
variant:

- ``plain`` imports torch only;
- ``port`` imports ``repro_torch.models`` first, as every path of the
  port does (its import makes each of those functions' first call on one
  thread, ``layers.first_calls_on_one_thread``).

Then, on ``--threads`` threads (8 by default, olmoe's CPU side), one f64
product of olmoe's first projection's shape (64 x 2048 by 2048 x 2048:
MKL and the thread pool start as the model starts them), then the first
calls: ``cos`` and ``sin`` of olmoe's RoPE angles (4 x 16 positions,
head dim 128, theta 10000: 4096 elements, two chunks on two threads;
``--chunks K`` repeats them to K chunks on K threads), then ``exp``,
``log``, ``sqrt``, ``tanh`` of 4096 elements each; then each call
again.  A process's line gives, for each function whose first call
differs from its second, the first element that differs and the bits
(``oplog.bit_parting``), the chunk it lies in, and each call's largest
error relative to the C library's value (Python's ``math``).  The
variants alternate, ``--at-once`` processes at a time, until each has
run ``--processes`` or ``--seconds`` have passed; the last line counts
the processes of each variant and those whose first calls differ, by
function.  Lines go also to
``--out`` (default ``chiprun_out/vml_first_call.jsonl``).
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 2048            # torch's grain for these functions on the CPU
OPS = ("cos", "sin", "exp", "log", "sqrt", "tanh")


def inputs(torch, chunks):
    """Each function's input: RoPE's angles for cos and sin, as
    ``layers._rope_angles`` makes them in f64 (repeated to ``chunks``
    chunks); a spread of values for the rest."""
    f64 = torch.float64
    positions = torch.arange(16).expand(4, 16)
    ar = torch.arange(0, 128, 2, dtype=f64)
    ang = positions.to(f64)[..., None] * (1.0 / (10000.0 ** (ar / 128)))
    ang = ang.repeat(chunks // 2, 1, 1)
    x = torch.linspace(-6.0, 6.0, 4096, dtype=f64)
    return {"cos": ang, "sin": ang, "exp": x, "log": x.abs() + 0.5,
            "sqrt": x.abs() + 0.5, "tanh": x}


def child(variant: str, threads: int, chunks: int) -> dict:
    """One process: the variant's import, the product, the first calls
    and the second calls."""
    if variant == "port":
        sys.path.insert(0, str(ROOT / "src"))
        import repro_torch.models  # noqa: F401
    import torch
    torch.set_num_threads(threads)
    a = torch.ones(64, 2048, dtype=torch.float64)
    (a @ torch.ones(2048, 2048, dtype=torch.float64)).sum()
    xs = inputs(torch, chunks)
    first = {op: getattr(torch, op)(xs[op]) for op in OPS}
    second = {op: getattr(torch, op)(xs[op]) for op in OPS}
    out = {"variant": variant, "threads": threads, "chunks": chunks,
           "differ": {}}
    if all(torch.equal(first[op], second[op]) for op in OPS):
        return out
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.oplog import bit_parting
    for op in OPS:
        libm = torch.tensor([getattr(math, op)(v) for v in
                             xs[op].reshape(-1).tolist()],
                            dtype=torch.float64)

        def rel(t):
            return float(((t.reshape(-1) - libm).abs()
                          / libm.abs().clamp_min(1e-300)).max())

        bits = bit_parting([first[op]], [second[op]])
        if bits is not None:
            bits["chunk"] = bits["element"] // CHUNK
            bits["first_vs_libm"] = rel(first[op])
            bits["second_vs_libm"] = rel(second[op])
            out["differ"][op] = bits
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]))), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=200,
                    help="processes of each variant")
    ap.add_argument("--seconds", type=float, default=float("inf"))
    ap.add_argument("--at-once", type=int, default=8)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "vml_first_call.jsonl"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    def run(k):
        variant = ("plain", "port")[k % 2]
        got = subprocess.run([sys.executable, __file__, "--child", variant,
                              str(args.threads), str(args.chunks)],
                             capture_output=True, text=True)
        lines = got.stdout.strip().splitlines()
        if got.returncode or not lines:
            return {"variant": variant, "failed": got.returncode,
                    "stderr": got.stderr[-2000:]}
        return json.loads(lines[-1])

    t0 = time.perf_counter()
    counts = {v: {"processes": 0, "failed": 0, "differ": 0, "by_op": {}}
              for v in ("plain", "port")}
    with ThreadPoolExecutor(args.at_once) as pool:
        live, k = [], 0
        while live or k < 2 * args.processes:
            while (k < 2 * args.processes and len(live) < args.at_once
                   and time.perf_counter() - t0 < args.seconds):
                live.append((k, pool.submit(run, k)))
                k += 1
            if not live:
                break
            i, future = live.pop(0)
            rec = future.result()
            c = counts[rec["variant"]]
            c["processes"] += 1
            if "failed" in rec:
                c["failed"] += 1
                emit({"process": i, **rec})
                continue
            if rec["differ"]:
                c["differ"] += 1
                for op in rec["differ"]:
                    c["by_op"][op] = c["by_op"].get(op, 0) + 1
                emit({"process": i, **rec})
    emit({"summary": counts, "threads": args.threads,
          "chunks": args.chunks,
          "at_once": args.at_once, "cpus": os.cpu_count(),
          "seconds": time.perf_counter() - t0})
    failed = sum(c["failed"] for c in counts.values())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

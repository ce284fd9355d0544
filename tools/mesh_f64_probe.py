#!/usr/bin/env python3
"""``chip_smoke.py``'s 4-CPU-rank f64 hold, recomputed after the script
and after heat, to tell which side a failing hold came from.

    python3 tools/mesh_f64_probe.py [--main] [--ranks N] [--cycles N]
                                    [--out PATH]

The hold (``chip_smoke.mesh_cpu``): qwen2-0.5b at full width cut to 2
layers, f64, one train step from seed-1 masters on 4 CPU ranks (gloo,
a 2 x 2 mesh) against the same step on the card without a mesh, every
gradient within 1e-10 relative by norm.

With ``--main`` the probe first runs ``chip_smoke.main()`` in this
process (its output to ``<out>.main.log``) and keeps both sides of the
hold as that run computed them.  Then it recomputes both in the same
process: the 4 ranks once, the card step once, and prints per leaf
where each differs from what the run computed (elements that differ,
max abs difference, how many of them differ above the low 32 bits of
the f64), with what each rank process brought to its masters (CPU
capability, threads, CPU set, OpenMP / MKL / ATen environment, a hash
of its f32 draw) beside the probe's own.  ``--ranks`` times (default
0) it reruns the 4 ranks and holds them bit for bit against that
first run, each rank's draw against the probe's.  Then ``--cycles``
times (default 0) it heats the card with bf16 products for ``HEAT_S``
seconds and at once reruns the card step and three f64 products (an
attention-shaped ``bmm``, a
4096² product, a softmax), each held bit for bit against the cold run,
with the card's serial, temperature, SM clock and power from
``nvidia-smi``.  One JSON line per reading, also to ``--out`` (default
``chiprun_out/mesh_f64_probe.jsonl``).
"""
import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as C  # noqa: E402

ARCH = "qwen2-0.5b"
HEAT_S = 55.0       # long enough for the card to reach its power limit


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=serial,temperature.gpu,clocks.sm,"
         "power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def process_info() -> dict:
    """What a process brings to the masters it draws: its CPU
    capability, threads, CPU set, the environment that steers OpenMP,
    MKL and ATen, and a hash of qwen2-0.5b's f32 draw from seed 1."""
    cfg, _ = C.mesh_cpu_case(ARCH)
    draw = hashlib.md5()
    for a in C.tree_leaves(C.init_params(cfg, torch.Generator().manual_seed(
            1), "cpu")):
        draw.update(a.contiguous().numpy().tobytes())
    return {"capability": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads(),
            "cpus": len(os.sched_getaffinity(0)), "draw": draw.hexdigest(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("OMP", "MKL", "KMP", "ATEN", "GOMP"))}}


def probe_rank(rank, store, out, cases):
    """``chip_smoke.mesh_cpu_rank``, after writing this rank's
    :func:`process_info` (with 2 threads, as the rank runs) to
    ``<out>/info.<rank>.json``."""
    torch.set_num_threads(2)
    Path(out, f"info.{rank}.json").write_text(json.dumps(process_info()))
    C.mesh_cpu_rank(rank, store, out, cases)


def infos(work) -> list:
    return [json.loads(Path(work, f"info.{r}.json").read_text())
            for r in range(4)]


def ranks(tag: str) -> dict:
    """The 4 ranks' step, as ``mesh_cpu`` runs it, put together whole,
    with each rank's :func:`process_info`."""
    cfg, pipe = C.mesh_cpu_case(ARCH)
    work = C.ROOT / "build" / f"mesh_f64_probe_{tag}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    mp.start_processes(probe_rank, args=(
        str(work / "store"), str(work), {ARCH: (cfg, pipe)}), nprocs=4,
        join=True, start_method="spawn")
    whole = C.mesh_cpu_whole(work, ARCH)
    ranks_info = infos(work)
    shutil.rmtree(work)
    return {"loss": float(whole["loss"]), "grads": whole["grads"],
            "info": ranks_info}


def card(masters, cfg, batch) -> dict:
    params = C.tree_map(lambda a: a.cuda(), masters)
    loss, grads = C.loss_and_grads(cfg, params, batch, remat=False)
    return {"loss": float(loss),
            "grads": [g.double().cpu() for g in C.tree_leaves(grads)]}


def diff(a: torch.Tensor, b: torch.Tensor):
    """None where ``a`` equals ``b`` bit for bit, else how they part."""
    if torch.equal(a, b):
        return None
    d = a != b
    xor = a.view(torch.int64)[d] ^ b.view(torch.int64)[d]
    return {"n": int(d.sum()), "of": a.numel(),
            "max_abs": float((a - b).abs().max()),
            "rel_norm": float((a - b).norm() / b.norm()),
            "above_low_32_bits": int((xor >> 32).ne(0).sum())}


def products(seed: int) -> list:
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(14, 1024, 64, dtype=torch.float64, device="cuda",
                    generator=g)
    b = torch.randn(14, 64, 4096, dtype=torch.float64, device="cuda",
                    generator=g)
    c = torch.randn(4096, 4096, dtype=torch.float64, device="cuda",
                    generator=g)
    return [torch.bmm(a, b).cpu(), (c @ c).cpu(), torch.softmax(c, -1).cpu()]


def heat(seconds: float) -> str:
    x = torch.randn(8192, 8192, dtype=torch.bfloat16, device="cuda")
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    return smi()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--main", action="store_true")
    ap.add_argument("--cycles", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "mesh_f64_probe.jsonl"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    emit(card=smi(), torch=torch.__version__)
    cfg, pipe = C.mesh_cpu_case(ARCH)
    masters = C.mesh_cpu_masters(cfg)
    batch = pipe.device_batch(0, "cuda")
    names = C.leaf_names(masters)
    kept = {}
    if args.main:
        whole, step = C.mesh_cpu_whole, C.loss_and_grads

        def keep_whole(work, arch):
            w = whole(work, arch)
            if arch == ARCH:
                kept["ranks"] = {"loss": float(w["loss"]),
                                 "grads": [a.clone() for a in w["grads"]],
                                 "info": infos(work)}
            return w

        def keep_step(c, params, b, **kw):
            loss, grads = step(c, params, b, **kw)
            if c == cfg and kw.get("remat") is False:
                kept.setdefault("card", {"loss": float(loss), "grads": [
                    a.double().cpu() for a in C.tree_leaves(grads)]})
            return loss, grads

        rank_fn = C.mesh_cpu_rank
        C.mesh_cpu_whole, C.loss_and_grads = keep_whole, keep_step
        C.mesh_cpu_rank = probe_rank
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                rc = C.main()
            emit(main_rc=rc)
        except Exception as e:                   # the run's own failure
            emit(main_failed=repr(e)[:4000])
        finally:
            C.mesh_cpu_whole, C.loss_and_grads = whole, step
            C.mesh_cpu_rank = rank_fn
            Path(f"{out}.main.log").write_text(log.getvalue())
    parent = process_info()
    now = {"ranks": ranks("a"), "card": card(masters, cfg, batch)}
    for side, then in kept.items():
        emit(side=side, vs="the run's own", loss=then["loss"] -
             now[side]["loss"], leaves={n: diff(a, b) for n, a, b in zip(
                 names, then["grads"], now[side]["grads"])},
             info=then.get("info"))
    emit(parent=parent, ranks_now=now["ranks"]["info"])
    for i in range(args.ranks):
        again = ranks(f"r{i}")
        emit(ranks_run=i, loss=again["loss"] - now["ranks"]["loss"],
             leaves_differ={n: d for n, a, b in zip(
                 names, again["grads"], now["ranks"]["grads"])
                 if (d := diff(a, b))},
             draws_equal_parent=[x["draw"] == parent["draw"]
                                 for x in again["info"]],
             capabilities=[x["capability"] for x in again["info"]])
    emit(vs="card against ranks, now", worst=max(
        (float((a - b).norm() / b.norm()), n) for n, a, b in zip(
            names, now["card"]["grads"], now["ranks"]["grads"])))
    cold = products(0) if args.cycles else None
    for i in range(args.cycles):
        hot = heat(HEAT_S)
        got = card(masters, cfg, batch)
        emit(cycle=i, hot=hot, after=smi(),
             loss=got["loss"] - now["card"]["loss"],
             grads_differ={n: d for n, a, b in zip(
                 names, got["grads"], now["card"]["grads"])
                 if (d := diff(a, b))},
             products_differ=[j for j, (a, b) in enumerate(
                 zip(products(0), cold)) if not torch.equal(a, b)])
    return 0


if __name__ == "__main__":
    sys.exit(main())

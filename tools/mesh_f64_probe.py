#!/usr/bin/env python3
"""``chip_smoke.py``'s 4-CPU-rank f64 hold, rerun, counted and recorded
op by op, to tell which side a failing hold came from and which op of
the ranks parts.

    python3 tools/mesh_f64_probe.py [--main] [--ranks N] [--cycles N]
                                    [--record] [--record-every K]
                                    [--fill nan] [--load N]
                                    [--hashseed unset|random|same]
                                    [--tree DIR] [--out PATH]

The hold (``chip_smoke.mesh_cpu``): qwen2-0.5b at full width cut to 2
layers, f64, one train step from seed-1 masters on 4 CPU ranks (gloo,
a 2 x 2 mesh) against the same step on the card without a mesh, every
gradient within 1e-10 relative by norm.

With ``--main`` the probe first runs ``chip_smoke.main()`` in this
process (its output to ``<out>.main.log``) and keeps both sides of the
hold as that run computed them, with the ranks' stage digests, then
diffs them per leaf against a recomputation in the same process
(elements that differ, max abs difference, how many differ above the
low 32 bits of the f64) and names the first stage at which they part.

``--ranks N`` runs the 4 ranks N times, as ``mesh_cpu`` spawns them
(plain, each rank digesting each stage of its step), and prints one line
a run: the run's digest (one hash over the loss, every gradient and
every updated parameter, put together whole), each rank's hash seed,
the first stage at which the run's stage digests part from the first
run's and from the usual ones (``chip_smoke.MESH_CPU_USUAL_STAGES``),
and how the run parts from the first (per leaf); the last line counts
the runs of each digest and of each first parted stage.
``--hashseed`` sets each rank's ``PYTHONHASHSEED``: left unset
(``unset``, the default, as the hold runs), drawn at random for each
rank and written down (``random``), or one drawn value for all four
(``same``).
``--load N`` keeps N busy processes running beside the ranks.
``--fill nan`` fills every new tensor with NaN (PyTorch's
deterministic mode), so that a read of memory no op wrote shows.

``--record`` runs each rank's step under ``OpLog``
(``src/repro_torch/launch/oplog.py``, taken from this checkout whatever
``--tree`` says), a dispatch mode below DTensor that keeps, for every
local aten op and every collective, its index, name, shapes, dtype, call
site (the innermost line outside torch, or the autograd node running),
the op that wrote each tensor it reads, a 64-bit digest of each tensor
it writes (a collective's result when it is waited on) and each floating
output's sum and largest magnitude.  It flags an op that reads or writes
a buffer a collective has not finished with, an op off the rank's thread
and the ops that write NaN.  Every recorded run is held op by op against
the first recorded run with the usual digest: per rank, the first op
whose output parts, whether it was fed by the same ops (the op chose
differently) or not (what fed it did), and the size of the difference; a
run with another digest also gets the ops around it, and both runs'
records go to ``<out>.ops/``.  ``--record-every K`` records only every
K-th run.

``--tree DIR`` runs the ranks (and the card step) from another checkout
(its ``chip_smoke.py`` and ``src/``), e.g. a parent commit unpacked
with ``git archive``.  ``--cycles N`` heats the card with bf16 products
for ``HEAT_S`` seconds and at once reruns the card step and three f64
products, each held bit for bit against the cold run.

One JSON line per reading, also to ``--out`` (default
``chiprun_out/mesh_f64_probe.jsonl``).  A rank run takes 35-60 s on 8
cores; ``--main`` takes about 13 min.  Without a card the card side
is skipped.
"""
import argparse
import contextlib
import gzip
import hashlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tree_arg():
    """``--tree DIR`` from the command line, read before ``chip_smoke`` is
    imported (a spawned rank gets the parent's ``sys.argv``)."""
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--tree" and i + 1 < len(argv):
            return Path(argv[i + 1]).resolve()
        if a.startswith("--tree="):
            return Path(a.split("=", 1)[1]).resolve()
    return ROOT


TREE = _tree_arg()
sys.path.insert(0, str(TREE))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as C  # noqa: E402


def _oplog():
    """This checkout's ``repro_torch.launch.oplog``, whichever tree's
    ``repro_torch`` is imported."""
    path = ROOT / "src" / "repro_torch" / "launch" / "oplog.py"
    spec = importlib.util.spec_from_file_location("mesh_probe_oplog", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_log = _oplog()
OpLog, first_parting, flag_summary = (_log.OpLog, _log.first_parting,
                                      _log.flag_summary)

ARCH = "qwen2-0.5b"
HEAT_S = 55.0       # long enough for the card to reach its power limit
KEPT_RUNS = 3       # differing runs whose op records are kept


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,serial,"
             "temperature.gpu,clocks.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        return "no nvidia-smi"


def process_info(cfg) -> dict:
    """What a process brings to the masters it draws: its CPU
    capability, threads, CPU set, hash seed, the environment that steers
    OpenMP, MKL and ATen, and a hash of ``cfg``'s f32 draw from seed 1."""
    draw = hashlib.md5()
    for a in C.tree_leaves(C.init_params(cfg, torch.Generator().manual_seed(
            1), "cpu")):
        draw.update(a.contiguous().numpy().tobytes())
    return {"capability": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads(),
            "cpus": len(os.sched_getaffinity(0)), "draw": draw.hexdigest(),
            "hashseed": os.environ.get("PYTHONHASHSEED"), "pid": os.getpid(),
            "str_hash": hash("data"),
            "chip_smoke": C.__file__,
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("OMP", "MKL", "KMP", "ATEN", "GOMP"))}}


def process_state() -> dict:
    """What a spawned rank inherits from this process: the environment,
    ``sys.path``, the CPU set and the limits; and the host's free
    memory."""
    import resource
    mem = {}
    for line in Path("/proc/meminfo").read_text().splitlines()[:3]:
        k, v = line.split(":")
        mem[k] = v.strip()
    return {"env": dict(os.environ), "sys_path": list(sys.path),
            "cpus": sorted(os.sched_getaffinity(0)), "meminfo": mem,
            "limits": {n: resource.getrlimit(getattr(resource, n))
                       for n in ("RLIMIT_NOFILE", "RLIMIT_STACK",
                                 "RLIMIT_AS", "RLIMIT_MEMLOCK")},
            "threads": threading.active_count(),
            "torch_threads": torch.get_num_threads()}


# ------------------------------------------------------------ the ranks
def planted(stage: str):
    """``chip_smoke``'s ``Stages`` with the first element of ``stage``'s
    largest tensor made one ulp larger before it is digested, in place:
    the step goes on from the changed value."""

    class Planted(C.Stages):
        def __call__(self, label, tensors):
            if label == stage:
                t = tensors if isinstance(tensors, torch.Tensor) \
                    else max(tensors, key=torch.numel)
                with torch.no_grad():
                    a = _log.local_part(t)
                    at = (0,) * a.ndim
                    a[at] = torch.nextafter(a[at], a.new_tensor(
                        float("inf")))
            super().__call__(label, tensors)

    return Planted


def probe_rank(rank, store, out, cases, record, fill, runs=(None,)):
    """``chip_smoke.mesh_cpu_rank``, after writing this rank's
    :func:`process_info` (with 2 threads, as the rank runs) to
    ``<out>/info.<rank>.json``; with ``record`` under ``OpLog``, whose
    rows go to ``<out>/ops.<rank>.json.gz``; with ``fill`` "nan" every
    new tensor holds NaN (PyTorch's deterministic mode).  ``runs``: the
    step's runs in this process, in order, each in ``<out>/run<k>``
    where there are several: None as the hold runs it, "off" without the
    stage digests, or (stage, rank) with :func:`planted` on that rank."""
    torch.set_num_threads(2)
    cfg = next(iter(cases.values()))[0]
    Path(out, f"info.{rank}.json").write_text(json.dumps(process_info(cfg)))
    if fill == "nan":
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    plain = C.Stages
    for k, how in enumerate(runs):
        where = Path(out) / f"run{k}" if len(runs) > 1 else Path(out)
        where.mkdir(exist_ok=True)
        C.Stages = planted(how[0]) if isinstance(how, tuple) \
            and how[1] == rank else plain
        args = (rank, f"{store}{k}", str(where), cases)
        kw = {"staged": None} if how == "off" else {}
        if not record:
            C.mesh_cpu_rank(*args, **kw)
            continue
        with OpLog() as log:
            C.mesh_cpu_rank(*args, **kw)
        with gzip.open(where / f"ops.{rank}.json.gz", "wt") as f:
            json.dump(log.rows, f)
        (where / f"recorder.{rank}.json").write_text(json.dumps(
            {"ops": len(log.rows), "seconds": log.seconds}))
    C.Stages = plain


def _spawn(fn, args, seeds) -> None:
    """4 processes as ``mp.start_processes(..., start_method="spawn")``
    starts them, rank r with ``PYTHONHASHSEED`` ``seeds[r]`` (None:
    unset); if one fails the others are ended."""
    ctx = mp.get_context("spawn")
    saved, procs = os.environ.get("PYTHONHASHSEED"), []
    try:
        for r, seed in enumerate(seeds):
            if seed is None:
                os.environ.pop("PYTHONHASHSEED", None)
            else:
                os.environ["PYTHONHASHSEED"] = str(seed)
            p = ctx.Process(target=fn, args=(r, *args))
            p.start()
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                p.terminate()
            break
        time.sleep(0.2)
    for p in procs:
        p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")


def _seeds(how: str) -> list:
    draw = lambda: int.from_bytes(os.urandom(4), "little") or 1  # noqa: E731
    if how == "random":
        return [draw() for _ in range(4)]
    if how == "same":
        return [draw()] * 4
    return [None] * 4


def _digest(whole) -> str:
    """``chip_smoke.mesh_cpu_digest``, here so that another tree's ranks
    are hashed the same way."""
    h = hashlib.sha256(str(float(whole["loss"])).encode())
    for a in whole["grads"] + whole["params"]:
        h.update(a.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ranks(tag: str, seeds, record=False, fill=None, load=0, case=None,
          root=None, runs=(None,)) -> dict:
    """The 4 ranks' step, as ``mesh_cpu`` runs it, put together whole,
    with each rank's :func:`process_info`, the run's digest, its stage
    rows (``chip_smoke.mesh_cpu_stage_rows``: a stage a row, each rank's
    digest) and with ``record`` each rank's op rows.  ``case`` (config,
    pipeline) is the hold's unless given; the ranks work under ``root``
    (the checkout's build/ unless given).  With several ``runs``
    (:func:`probe_rank`), each run's reading is in ``runs``, and the
    first's is the whole reading as well."""
    cfg, pipe = case or C.mesh_cpu_case(ARCH)
    work = Path(root or C.ROOT / "build") / f"mesh_f64_probe_{tag}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(load)]
    try:
        _spawn(probe_rank, (str(work / "store"), str(work),
                            {ARCH: (cfg, pipe)}, record, fill, runs), seeds)
    finally:
        for b in burners:
            b.kill()
            b.wait()
    wall = time.perf_counter() - t0
    read = [_reading(work / f"run{k}" if len(runs) > 1 else work, record)
            for k in range(len(runs))]
    out = {**read[0], "wall_s": wall,
           "info": [json.loads(Path(work, f"info.{r}.json").read_text())
                    for r in range(4)]}
    if len(runs) > 1:
        out["runs"] = read
    shutil.rmtree(work)
    return out


def _reading(work: Path, record: bool) -> dict:
    """One run of the ranks in ``work``, put together whole."""
    whole = C.mesh_cpu_whole(work, ARCH)
    out = {"loss": float(whole["loss"]), "grads": whole["grads"],
           "nan": any(bool(a.isnan().any()) for a in whole["grads"]),
           "digest": _digest(whole),
           "replicas_differ": whole.get("replicas_differ", []),
           "stages": C.mesh_cpu_stage_rows(whole)
           if whole.get("stages") else None,
           "stages_s": [s["seconds"] for s in whole.get("stages", [])],
           "waited_s": [s["waited"] for s in whole.get("stages", [])]}
    if record:
        out["ops"] = []
        for r in range(4):
            with gzip.open(work / f"ops.{r}.json.gz", "rt") as f:
                out["ops"].append(json.load(f))
        out["recorder"] = [json.loads((work / f"recorder.{r}.json")
                                      .read_text()) for r in range(4)]
    return out


def stages_vs(rows, first, usual) -> dict:
    """Stage rows as a table (a stage's digests, one a rank), and where
    they part from the first run's and from the usual ones (None where
    there is no such record)."""
    if rows is None:
        return {}
    return {"stages": {r[0]: r[2] for r in rows},
            "vs_first": first and _log.parted_stage(rows, first),
            "vs_usual": usual and _log.parted_stage(rows, usual)}


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
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-every", type=int, default=1)
    ap.add_argument("--hashseed", default="unset",
                    choices=("unset", "random", "same"))
    ap.add_argument("--fill", choices=("nan",))
    ap.add_argument("--load", type=int, default=0)
    ap.add_argument("--tree")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "mesh_f64_probe.jsonl"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    has_card = torch.cuda.is_available()

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    emit(card=smi(), torch=torch.__version__, tree=str(TREE),
         args=vars(args))
    # keyed by torch version and a rank's threads; by the version alone
    # in a tree before that (--tree)
    table = getattr(C, "MESH_CPU_USUAL_STAGES", {})
    usual = table.get((torch.__version__, 2), table.get(torch.__version__))
    cfg, pipe = C.mesh_cpu_case(ARCH)
    masters = C.mesh_cpu_masters(cfg)
    names = C.leaf_names(masters)
    kept = {}
    if args.main:
        whole, step = C.mesh_cpu_whole, C.loss_and_grads

        def keep_whole(work, arch):
            w = whole(work, arch)
            if arch == ARCH:
                kept["ranks"] = {"loss": float(w["loss"]),
                                 "grads": [a.clone() for a in w["grads"]],
                                 "stages": C.mesh_cpu_stage_rows(w)
                                 if w.get("stages") else None}
            return w

        def keep_step(c, params, b, **kw):
            loss, grads = step(c, params, b, **kw)
            if c == cfg and kw.get("remat") is False:
                kept.setdefault("card", {"loss": float(loss), "grads": [
                    a.double().cpu() for a in C.tree_leaves(grads)]})
            return loss, grads

        C.mesh_cpu_whole, C.loss_and_grads = keep_whole, keep_step
        before = process_state()
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                rc = C.main()
            emit(main_rc=rc)
        except Exception as e:                   # the run's own failure
            emit(main_failed=repr(e)[:4000])
        finally:
            C.mesh_cpu_whole, C.loss_and_grads = whole, step
            Path(f"{out}.main.log").write_text(log.getvalue())
        after = process_state()
        emit(main_changed={k: [before[k], after[k]] for k in after
                           if before[k] != after[k]})
    now = {}
    if has_card:
        now["card"] = card(masters, cfg, pipe.device_batch(0, "cuda"))
    plan = [_seeds(args.hashseed) for _ in range(args.ranks)]
    if kept or not plan:
        now["ranks"] = ranks("a", _seeds(args.hashseed))
    for side, then in kept.items():
        emit(side=side, vs="the run's own", loss=then["loss"] -
             now[side]["loss"], leaves={n: diff(a, b) for n, a, b in zip(
                 names, then["grads"], now[side]["grads"])},
             **stages_vs(then.get("stages"), now[side].get("stages"),
                         usual))
    first, base_ops, counts, saved = now.get("ranks"), None, {}, 0
    parted = {}
    ops_dir = Path(f"{out}.ops")
    for i, seeds in enumerate(plan):
        record = args.record and (i + 1) % args.record_every == 0
        again = ranks(f"r{i}", seeds, record, args.fill, args.load)
        counts[again["digest"]] = counts.get(again["digest"], 0) + 1
        rec = {"ranks_run": i, "digest": again["digest"],
               "hashseeds": seeds, "wall_s": again["wall_s"],
               "recorded": record, "loss": again["loss"],
               "recorder": again.get("recorder"),
               "replicas_differ": again["replicas_differ"],
               "nan": again["nan"],
               "str_hashes": [x["str_hash"] for x in again["info"]],
               "capabilities": [x["capability"] for x in again["info"]],
               "stages_s": again["stages_s"],
               "waited_s": again["waited_s"],
               **stages_vs(again["stages"], (first or again)["stages"],
                           usual)}
        where = rec.get("vs_usual") or rec.get("vs_first") or {}
        where = where.get("stage", where.get("kind"))
        parted[where] = parted.get(where, 0) + 1
        if "card" in now:
            rec["vs_card"] = max(
                (float((a - b).norm() / b.norm()), n) for n, a, b in zip(
                    names, again["grads"], now["card"]["grads"]))
        if record:
            rec["flags"] = [flag_summary(ops) for ops in again["ops"]]
            if base_ops is not None:
                parting = [first_parting(a, b) for a, b in zip(
                    base_ops["ops"], again["ops"])]
                rec["op_parting"] = [{k: p.get(k) for k in (
                    "index", "kind", "op", "site", "size")}
                    for p in parting]
        first = first or again
        if again["digest"] != first["digest"]:
            rec["vs_first"] = {"loss": again["loss"] - first["loss"],
                               "leaves": {n: d for n, a, b in zip(
                                   names, again["grads"], first["grads"])
                                   if (d := diff(a, b))}}
            if record and base_ops is not None:
                rec["parting"] = parting
                if saved < KEPT_RUNS:
                    ops_dir.mkdir(parents=True, exist_ok=True)
                    for run in (base_ops, again):
                        with gzip.open(ops_dir / f"run{run['i']}.json.gz",
                                       "wt") as f:
                            json.dump({"digest": run["digest"],
                                       "ops": run["ops"]}, f)
                    saved += 1
        emit(**rec)
        if record and base_ops is None \
                and again["digest"] == first["digest"]:
            base_ops = {"i": i, "digest": again["digest"],
                        "ops": again["ops"]}
        again.pop("ops", None)
    if plan:
        emit(runs=len(plan), digests=counts,
             first=first["digest"] if first else None,
             first_parted_stages=parted, usual_stages_known=bool(usual))
    if "card" in now and "ranks" in now:
        emit(vs="card against ranks, now", worst=max(
            (float((a - b).norm() / b.norm()), n) for n, a, b in zip(
                names, now["card"]["grads"], now["ranks"]["grads"])))
    cold = products(0) if args.cycles else None
    batch = pipe.device_batch(0, "cuda") if args.cycles else None
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

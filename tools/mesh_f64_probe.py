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
hold as that run computed them, then diffs them per leaf against a
recomputation in the same process (elements that differ, max abs
difference, how many differ above the low 32 bits of the f64).

``--ranks N`` runs the 4 ranks N times, as ``mesh_cpu`` spawns them,
and prints one line a run: the run's digest (one hash over the loss,
every gradient and every updated parameter, put together whole), each
rank's hash seed, and how the run parts from the first (per leaf); the
last line counts the runs of each digest.  ``--hashseed`` sets each
rank's ``PYTHONHASHSEED``: left unset (``unset``, the default, as the
hold runs), drawn at random for each rank and written down
(``random``), or one drawn value for all four (``same``).
``--load N`` keeps N busy processes running beside the ranks.
``--fill nan`` fills every new tensor with NaN (PyTorch's
deterministic mode), so that a read of memory no op wrote shows.

``--record`` runs each rank's step under :class:`OpLog`, a dispatch
mode below DTensor that keeps, for every local aten op and every
collective, its index, name, shapes, dtype, call site (the
innermost line of the port, or the autograd node running) and a CRC-32
of each tensor it reads and each it writes (a collective's result when
it is waited on).  It flags an op that reads or writes a buffer a
collective has not finished with, an op off the rank's thread and (with
``--fill nan``) the ops that write NaN.  Every recorded run is held op
by op against the first recorded run with the usual digest: per rank,
the first op whose output parts, and whether its inputs agreed (the op
chose differently) or not (what fed it did); a run with another digest
also gets the ops around it, and both runs' records go to
``<out>.ops/``.  ``--record-every K`` records only every K-th run.

``--tree DIR`` runs the ranks (and the card step) from another checkout
(its ``chip_smoke.py`` and ``src/``), e.g. a parent commit unpacked
with ``git archive``.  ``--cycles N`` heats the card with bf16 products
for ``HEAT_S`` seconds and at once reruns the card step and three f64
products, each held bit for bit against the cold run.

One JSON line per reading, also to ``--out`` (default
``chiprun_out/mesh_f64_probe.jsonl``).  A rank run takes 35-60 s on 8
cores, with ``--record`` 95-115 s, with ``--fill nan`` as well
115-140 s; ``--main`` takes about 13 min.  Without a card the card side
is skipped.
"""
import argparse
import contextlib
import gzip
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib
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
from torch.distributed._functional_collectives import \
    AsyncCollectiveTensor  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import chip_smoke as C  # noqa: E402

ARCH = "qwen2-0.5b"
HEAT_S = 55.0       # long enough for the card to reach its power limit
KEPT_RUNS = 3       # differing runs whose op records are kept
AROUND = 3          # ops shown before and after the first that parts


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


# ------------------------------------------------------------ op records
def _crc(t: torch.Tensor) -> int:
    t = t.detach()
    if t.numel() == 0:
        return 0
    t = t.contiguous().reshape(-1)
    if t.dtype.is_complex or t.is_conj() or t.is_neg():
        t = t.resolve_conj().resolve_neg()
    return zlib.crc32(t.view(torch.uint8).numpy())


def _plain(t) -> bool:
    return type(t) is torch.Tensor and t.device.type == "cpu"


def _flat(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _flat(y)
    else:
        yield x


def _site() -> str:
    """The innermost line of the port or of ``chip_smoke.py`` on the
    stack, with the autograd node running (the backward's only trace)."""
    node = torch._C._current_autograd_node()
    where, f = "", sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            where = f"{Path(name).name}:{f.f_lineno} {f.f_code.co_name}"
            break
        f = f.f_back
    return f"{where} [{node.name()}]" if node is not None else where


class OpLog(TorchDispatchMode):
    """Every local aten op and every collective a rank runs, below
    DTensor (an op on DTensors is left to DTensor, which runs it on the
    rank's shards, and those come here): one row each, ``[index, op,
    site, input shapes, output shapes and dtypes, input CRCs, output
    CRCs, flags]``.  A collective's
    result is pending until its ``wait_tensor``: it is not read for a
    digest before, and an op that reads or writes it, or writes a
    collective's input, before then is flagged (``reads_pending``,
    ``writes_pending``) with the collective's index."""

    COLLECTIVE = ("_c10d_functional", "c10d", "_dtensor")
    WRAPPERS = (DTensor, AsyncCollectiveTensor)
    NO_READ = ("wait_tensor", "_wrap_tensor_autograd")
    EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")

    def __init__(self, nan: bool = False) -> None:
        super().__init__()
        self.nan, self.rows = nan, []
        self.pending_out, self.pending_in = {}, {}
        self.thread = threading.get_ident()

    @staticmethod
    def _key(t):
        return t.untyped_storage().data_ptr()

    def _crcs(self, ts):
        return [None if self._key(t) in self.pending_out else _crc(t)
                for t in ts]

    def _nan(self, ts) -> bool:
        return any(t.is_floating_point() and self._key(t)
                   not in self.pending_out and bool(t.isnan().any())
                   for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.WRAPPERS) for t in types):
            return NotImplemented        # run on the shards: they come here
        if types:                        # fake tensors: shapes, no data
            return func(*args, **kwargs)
        ns, name = func.namespace, str(func.overloadpacket).split(".")[-1]
        outs_given = {id(v) for k, v in kwargs.items()
                      if k == "out" or k.startswith("out")}
        ins = [t for t in _flat((args, kwargs))
               if _plain(t) and id(t) not in outs_given]
        written = [a for a, s in zip(args, func._schema.arguments)
                   if s.alias_info is not None and s.alias_info.is_write
                   and _plain(a)]
        flags = {}
        keys = [self._key(t) for t in ins]
        if name not in self.NO_READ and not func.is_view:
            hit = [self.pending_out[k] for k in keys if k in self.pending_out]
            if hit:
                flags["reads_pending"] = hit[0]
            hit = [self.pending_in[self._key(t)] for t in written
                   if self._key(t) in self.pending_in]
            if hit:
                flags["writes_pending"] = hit[0]
        if func.is_view:
            flags["view"] = 1
        if threading.get_ident() != self.thread:
            flags["thread"] = threading.get_ident()
        before = self._crcs(ins)
        if self.nan and self._nan(ins):
            flags["nan_in"] = 1
        out = func(*args, **kwargs)
        outs = [t for t in _flat(out) if _plain(t)]
        idx = len(self.rows)
        if ns in self.COLLECTIVE:
            if name == "wait_tensor":
                # a wait ends the collective whose result this is
                done = {self.pending_out.pop(k) for k in keys
                        if k in self.pending_out}
                self.pending_in = {k: v for k, v in self.pending_in.items()
                                   if v not in done}
            elif ns == "_c10d_functional" and name not in self.NO_READ:
                for t in outs:
                    self.pending_out[self._key(t)] = idx
                for t in ins:
                    self.pending_in[self._key(t)] = idx
        if name in self.EMPTY or (ns in self.COLLECTIVE
                                  and name != "wait_tensor"):
            after = []                   # nothing written yet
        else:
            after = self._crcs(outs)
            if self.nan and self._nan(outs):
                flags["nan_out"] = 1
        self.rows.append([
            idx, f"{ns}.{name}", _site(),
            [list(t.shape) for t in ins],
            [f"{list(t.shape)}{str(t.dtype)[6:]}" for t in outs],
            before, after, flags])
        return out


def flag_summary(rows: list) -> dict:
    """Per flag, how many ops carry it, and the first ops (not views)
    that wrote NaN (with ``--fill nan``: where memory that no op had
    written was read, or a buffer was left partly unwritten)."""
    out = {"nan_ops": []}
    for r in rows:
        for k in r[7]:
            if k != "view":
                out[k] = out.get(k, 0) + 1
        if "nan_out" in r[7] and "view" not in r[7] \
                and len(out["nan_ops"]) < 8:
            out["nan_ops"].append(r[:3] + [r[7]])
    return out


def first_parting(a: list, b: list) -> dict:
    """Where two ranks' records (same rank, two runs) first part: the
    op sequence (another op, or other shapes), or the first op whose
    output CRCs differ, and whether its inputs agreed; with the ops
    around it in both runs."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[1] != y[1] or x[3] != y[3] or x[4] != y[4]:
            kind = "sequence"
        elif x[6] != y[6] and "view" not in x[7]:
            # a view restates its storage, which may not be written yet
            kind = "op chose differently (inputs agree)" \
                if x[5] == y[5] else "inputs differ"
        else:
            continue
        lo = max(0, i - AROUND)
        return {"index": i, "kind": kind, "ops": len(a),
                "first": a[lo:i + AROUND + 1],
                "second": b[lo:i + AROUND + 1]}
    if len(a) != len(b):
        return {"index": min(len(a), len(b)), "kind": "length",
                "ops": [len(a), len(b)]}
    return {"index": None, "kind": "equal", "ops": len(a)}


# ------------------------------------------------------------ the ranks
def probe_rank(rank, store, out, cases, record, fill):
    """``chip_smoke.mesh_cpu_rank``, after writing this rank's
    :func:`process_info` (with 2 threads, as the rank runs) to
    ``<out>/info.<rank>.json``; with ``record`` under :class:`OpLog`,
    whose rows go to ``<out>/ops.<rank>.json.gz``; with ``fill`` "nan"
    every new tensor holds NaN (PyTorch's deterministic mode) and the
    rows flag NaN read and written."""
    torch.set_num_threads(2)
    cfg = next(iter(cases.values()))[0]
    Path(out, f"info.{rank}.json").write_text(json.dumps(process_info(cfg)))
    if fill == "nan":
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    if not record:
        C.mesh_cpu_rank(rank, store, out, cases)
        return
    with OpLog(fill == "nan") as log:
        C.mesh_cpu_rank(rank, store, out, cases)
    with gzip.open(Path(out, f"ops.{rank}.json.gz"), "wt") as f:
        json.dump(log.rows, f)


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
    h = hashlib.sha256(str(float(whole["loss"])).encode())
    for a in whole["grads"] + whole["params"]:
        h.update(a.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ranks(tag: str, seeds, record=False, fill=None, load=0, case=None,
          root=None) -> dict:
    """The 4 ranks' step, as ``mesh_cpu`` runs it, put together whole,
    with each rank's :func:`process_info`, the run's digest, and with
    ``record`` each rank's op rows.  ``case`` (config, pipeline) is the
    hold's unless given; the ranks work under ``root`` (the checkout's
    build/ unless given)."""
    cfg, pipe = case or C.mesh_cpu_case(ARCH)
    work = Path(root or C.ROOT / "build") / f"mesh_f64_probe_{tag}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(load)]
    try:
        _spawn(probe_rank, (str(work / "store"), str(work),
                            {ARCH: (cfg, pipe)}, record, fill), seeds)
    finally:
        for b in burners:
            b.kill()
            b.wait()
    wall = time.perf_counter() - t0
    whole = C.mesh_cpu_whole(work, ARCH)
    out = {"loss": float(whole["loss"]), "grads": whole["grads"],
           "nan": any(bool(a.isnan().any()) for a in whole["grads"]),
           "digest": _digest(whole), "wall_s": wall,
           "replicas_differ": whole.get("replicas_differ", []),
           "info": [json.loads(Path(work, f"info.{r}.json").read_text())
                    for r in range(4)]}
    if record:
        out["ops"] = []
        for r in range(4):
            with gzip.open(Path(work, f"ops.{r}.json.gz"), "rt") as f:
                out["ops"].append(json.load(f))
    shutil.rmtree(work)
    return out


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
                                 "grads": [a.clone() for a in w["grads"]]}
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
                 names, then["grads"], now[side]["grads"])})
    first, base_ops, counts, saved = now.get("ranks"), None, {}, 0
    ops_dir = Path(f"{out}.ops")
    for i, seeds in enumerate(plan):
        record = args.record and (i + 1) % args.record_every == 0
        again = ranks(f"r{i}", seeds, record, args.fill, args.load)
        counts[again["digest"]] = counts.get(again["digest"], 0) + 1
        rec = {"ranks_run": i, "digest": again["digest"],
               "hashseeds": seeds, "wall_s": again["wall_s"],
               "recorded": record, "loss": again["loss"],
               "replicas_differ": again["replicas_differ"],
               "nan": again["nan"],
               "str_hashes": [x["str_hash"] for x in again["info"]],
               "capabilities": [x["capability"] for x in again["info"]]}
        if "card" in now:
            rec["vs_card"] = max(
                (float((a - b).norm() / b.norm()), n) for n, a, b in zip(
                    names, again["grads"], now["card"]["grads"]))
        if record:
            rec["flags"] = [flag_summary(ops) for ops in again["ops"]]
            if base_ops is not None:
                parting = [first_parting(a, b) for a, b in zip(
                    base_ops["ops"], again["ops"])]
                rec["op_parting"] = [{k: p[k] for k in ("index", "kind")}
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
             first=first["digest"] if first else None)
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

#!/usr/bin/env python3
"""olmoe-1b-7b's f64 forward on the card against the CPU, op by op,
repeated in one process after the caching allocator has been filled.

    python3 tools/moe_f64_probe.py [--reps N] [--out PATH]

The cell of ``chip_smoke.py``'s olmoe check (``moe_card_vs_cpu``):
olmoe-1b-7b at full width cut to 2 layers, f32 masters from seed 1 on
the card cast to f64, their host copy on the CPU, 4 rows of 16 tokens.
The CPU's forward runs twice under a dispatch mode that keeps every
aten op's output (its name, and the layer and MoE stage it ran in:
attention, router probabilities, dispatch and combine masks, experts);
the card's then runs ``--reps`` times (default 10), each after a
different filling of the allocator: none, freed blocks holding NaN,
holding random f64, holding random f32 (as an f32 run leaves them),
the same released to the driver (``empty_cache``) and reallocated, and
with PyTorch's deterministic mode filling every new tensor with NaN.
Each rep compares every op's output with the CPU's of the same stage,
name, shape and count
and prints one JSON line: the logits' max abs error against the CPU,
whether the picks are equal, and the first ops whose error exceeds
1e-12 of their scale, with their stage.  Then the 16 decode steps and
the forward as ``chip_smoke.py`` runs them (``decode_and_forward``),
``--reps`` times without the dispatch mode.  Lines also go to ``--out``
(default ``chiprun_out/moe_f64_probe.jsonl``).

    python3 tools/moe_f64_probe.py --cpu-processes N [--record]
                                   [--out PATH]

runs instead the CPU side of that check (``chip_smoke.moe_card_vs_cpu``:
the seed-1 masters drawn on the card, the 16 decode steps and the
forward in f64 on the host) N times, each in a fresh process, and
prints one line a process with a hash of its logits and of its picks
(and where each stage's first tensor lay: its address modulo 4096),
their max abs difference from the first process's and from the card's
forward and decode (run once in this process, as the check runs them:
the usual card-against-CPU reading), each stage's digest
(``chip_smoke.moe_cpu_run``: the masters as cast, the tokens, each
layer's attention, router probabilities, MoE and output, the final norm,
the logits) and the first stage at which they part from the first
process's and from the usual ones (``chip_smoke.MOE_CPU_USUAL_STAGES``),
with the size of the difference there by max abs and by norm (about 25
s a process); then the count of each hash and of each first parted
stage.  With ``--record`` every
process runs under the port's op recorder
(``repro_torch.launch.oplog.OpLog``: the op that wrote each input, a
digest, sum and largest magnitude of each output) and each later
process's record is held against the first's (``first_parting``: the
first op that parts, its site, whether its inputs agreed and the size
of the difference).
"""
import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.oplog import (OpLog, Stages,  # noqa: E402
                                      first_parting, parted_stage)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params, tree_map  # noqa: E402

ARCH, N_LAYERS, BATCH, TOKENS = "olmoe-1b-7b", 2, 4, 16
KEEP_NUMEL = 1 << 25        # outputs larger than this are not kept
REL = 1e-12                 # an op differs above REL of its scale
FILL_BYTES = 24 << 30
FILLS = ("none", "nan", "rand64", "rand32", "released", "deterministic")


class _Stages:
    """The stage each op runs in: the layer, and the MoE's function in
    it, by wrapping the model's functions while the probe runs."""

    def __init__(self) -> None:
        self.stack = []
        self.layer = -1

    @contextlib.contextmanager
    def installed(self):
        wraps = [(M, "_dense_block"), (M, "attention"), (M, "moe"),
                 (L, "moe_route"), (L, "_router_probs"), (L, "_dispatch"),
                 (L, "_experts"), (M, "_logits")]
        saved = [(mod, name, getattr(mod, name)) for mod, name in wraps]
        for mod, name, fn in saved:
            setattr(mod, name, self._wrap(name, fn))
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def _wrap(self, name, fn):
        def run(*a, **kw):
            if name == "_dense_block":
                self.layer += 1
            self.stack.append(name)
            try:
                return fn(*a, **kw)
            finally:
                self.stack.pop()
        return run

    def label(self) -> str:
        return f"layer {self.layer}: " + "/".join(self.stack)


class _Record(TorchDispatchMode):
    """Every op's outputs, each keyed by its stage, name, shape and dtype
    and its count among ops of that key: kept on the host, or, given
    ``want`` (the keys and outputs of a kept run), compared with the
    output of the same key as they come.  Keys on one side only are
    listed (``unmatched``)."""

    def __init__(self, stages, want=None) -> None:
        super().__init__()
        self.stages, self.want = stages, want
        self.ops, self.diffs, self.unmatched = {}, [], []
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func).startswith(("aten.empty", "aten.new_empty")):
            return out                  # holds nothing yet
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            base = (self.stages.label(), str(func), tuple(t.shape),
                    str(t.dtype))
            n = self.count[base] = self.count.get(base, -1) + 1
            key = base + (n,)
            host = t.detach().cpu().clone() \
                if t.numel() <= KEEP_NUMEL else None
            self.ops[key] = host if self.want is None else None
            if self.want is None or host is None:
                continue
            if key not in self.want:
                self.unmatched.append(" ".join(map(str, key)))
                continue
            ref = self.want[key]
            if ref is None:
                continue
            if host.dtype.is_floating_point:
                d = (host.double() - ref.double()).abs()
                err = float(d.max()) if d.numel() else 0.0
                scale = float(ref.double().abs().max()) if ref.numel() \
                    else 0.0
            else:
                err = float(not torch.equal(host, ref))
                scale = 1.0
            if not err <= REL * max(scale, 1e-300):
                self.diffs.append({"op": len(self.ops) - 1,
                                   "key": " ".join(map(str, key)),
                                   "max_abs_err": err, "scale": scale})
        return out


def fill(kind: str) -> None:
    """Leave the allocator's free blocks holding ``kind``'s data."""
    torch.cuda.empty_cache()
    if kind in ("none", "deterministic"):
        return
    blocks, left, size = [], FILL_BYTES, 1 << 20
    while left > 0:
        n = min(size, left)
        if kind == "nan":
            t = torch.full((n // 8,), float("nan"), dtype=torch.float64,
                           device="cuda")
        elif kind == "rand32":
            t = torch.randn(n // 4, device="cuda")
        else:
            t = torch.randn(n // 8, dtype=torch.float64, device="cuda")
        blocks.append(t)
        left -= n
        size = min(size * 2, 2 << 30)
    torch.cuda.synchronize()
    del blocks
    if kind == "released":
        torch.cuda.empty_cache()


def picks_of(fn):
    """``fn()`` and the experts each MoE call picked, on the host (moved
    there after ``fn``, so that no copy runs among its ops)."""
    orig, kept = L.moe_route, []

    def route(cfg, p, x):
        got = orig(cfg, p, x)
        kept.append(got[0])
        return got

    L.moe_route = route
    try:
        out = fn()
    finally:
        L.moe_route = orig
    return out, [k.cpu() for k in kept]


def emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    return C


class _Placed(Stages):
    """``Stages`` that also keeps where each stage's first tensor lies:
    its address modulo 4096 (``offsets``)."""

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        self.offsets = {}

    def __call__(self, label, tensors):
        super().__call__(label, tensors)
        t = tensors if isinstance(tensors, torch.Tensor) else tensors[0]
        self.offsets[self.rows[-1][0]] = t.data_ptr() % 4096


def cpu_once(save=None, record=None) -> dict:
    """The f64 CPU side of ``chip_smoke.moe_card_vs_cpu`` in this
    process, its stages digested (``chip_smoke.moe_cpu_run``): hashes of
    its decode and forward logits and of its picks, and each stage's
    digest.  With ``save`` (a path) the logits and the tensors of every
    stage but the masters are saved there.  With ``record`` (a path) the
    run is recorded by ``OpLog``, whose rows are written there.  It runs
    as the check does (``chip_smoke.moe_cpu_side``: on
    ``MOE_CPU_THREADS`` threads), and gives its CPU conditions
    (``conditions``)."""
    C = _chip_smoke()
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=N_LAYERS)
    host = tree_map(lambda a: a.cpu(), C.cut_params(cfg, 1))
    c = dataclasses.replace(cfg, dtype="float64")
    stages = _Placed(keep=KEEP_NUMEL)
    conditions = {}

    def run():
        got, picks, now = C.moe_cpu_side(
            c, M._cast(host, torch.float64), C.decode_tokens(cfg).cpu(),
            stages)
        conditions.update(now)
        return got, picks

    t0 = time.perf_counter()
    extra = {}
    if record:
        with OpLog() as log:
            (dec, full), picks = run()
        with gzip.open(record, "wt") as f:
            json.dump(log.rows, f)
        extra = {"ops": len(log.rows), "recorder_s": log.seconds}
    else:
        (dec, full), picks = run()
    if save:
        torch.save({"logits": [dec, full], "stages": stages.kept}, save)
    return {"decode": C.sha16([dec]), "forward": C.sha16([full]),
            "picks": C.sha16(picks), "cpu_s": time.perf_counter() - t0,
            "threads": conditions["threads"],
            "stages": stages.rows, "digests_s": stages.seconds,
            "offsets": stages.offsets, "conditions": conditions,
            "cpus": len(os.sched_getaffinity(0)), "pid": os.getpid(),
            "recorded": bool(record), **extra}


def stage_size(a: list, b: list):
    """The difference of one stage's kept tensors in two runs: max abs
    and norm, absolute and relative to the second's (None where they
    were not kept)."""
    if a is None or b is None:
        return None
    d = [(x.double() - y.double()) for x, y in zip(a, b)]
    norm = float(sum(float(v.norm()) ** 2 for v in d) ** 0.5)
    ref = float(sum(float(y.double().norm()) ** 2 for y in b) ** 0.5)
    return {"max_abs": max(float(v.abs().max()) for v in d),
            "norm": norm, "rel_norm": norm / ref if ref else None}


def card_reading():
    """The card's f64 decode and forward logits, as
    ``chip_smoke.moe_card_vs_cpu`` computes them (seed-1 masters drawn on
    the card, cast to f64), on the host."""
    C = _chip_smoke()
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=N_LAYERS)
    masters = C.cut_params(cfg, 1)
    c = dataclasses.replace(cfg, dtype="float64")
    got = C.decode_and_forward(c, M._cast(masters, torch.float64),
                               C.decode_tokens(cfg))
    out = [a.cpu() for a in got]
    del masters, got
    torch.cuda.empty_cache()
    return out


def _rows(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def cpu_processes(n: int, out: str, record=False) -> None:
    """``n`` fresh processes of :func:`cpu_once`, each one's decode and
    forward logits held against the first's and the card's by value (max
    abs difference), each one's stages against the first's and the usual
    ones (the first parted stage, with its size against the first's
    where its tensors were kept); with ``record`` each one runs under
    ``OpLog`` and each later one's record is held against the first's
    (``first_parting``, with the rows around the parting where its
    logits differ).  The last line counts the processes of each hash and
    of each first parted stage, and gives, for each hash, the largest
    difference of its processes from the first's and from the card's."""
    C = _chip_smoke()
    usual = C.MOE_CPU_USUAL_STAGES.get(C.usual_key(C.MOE_CPU_THREADS))
    counts, largest, parted, vs_card = {}, {}, {}, {}
    work = ROOT / "build" / "moe_cpu_processes"
    work.mkdir(parents=True, exist_ok=True)
    card = card_reading()
    base = None
    for i in range(n):
        cmd = [sys.executable, __file__, "--cpu-once", "--save",
               str(work / f"{i}.pt")]
        if record:
            cmd += ["--record", str(work / f"{i}.rows.json.gz")]
        got = subprocess.run(cmd, capture_output=True, text=True)
        line = got.stdout.strip().splitlines()
        rec = json.loads(line[-1]) if got.returncode == 0 and line else {
            "failed": got.returncode, "stderr": got.stderr[-2000:]}
        if "failed" not in rec:
            now, first = (torch.load(work / f"{j}.pt") for j in (i, 0))
            rec["vs_first_max_abs"] = [
                float((a - b).abs().max())
                for a, b in zip(now["logits"], first["logits"])]
            rec["vs_card_max_abs"] = [float((a - b).abs().max())
                                      for a, b in zip(now["logits"], card)]
            rows = rec.pop("stages")
            base = base or rows
            rec["stages"] = {r[0]: r[1] for r in rows}
            rec["stages_vs_first"] = parted_stage(rows, base)
            rec["stages_vs_usual"] = usual and parted_stage(rows, usual)
            at = rec["stages_vs_first"].get("stage")
            if at is not None:
                rec["stages_vs_first"]["size"] = stage_size(
                    now["stages"].get(at), first["stages"].get(at))
            where = rec["stages_vs_usual"] or rec["stages_vs_first"]
            where = where.get("stage", where["kind"])
            parted[where] = parted.get(where, 0) + 1
            if record and i:
                got = first_parting(_rows(work / "0.rows.json.gz"),
                                    _rows(work / f"{i}.rows.json.gz"))
                if not any(rec["vs_first_max_abs"]):
                    got.pop("first", None)
                    got.pop("second", None)
                rec["parting"] = got
                (work / f"{i}.rows.json.gz").unlink()
            if i:
                (work / f"{i}.pt").unlink()
        key = str((rec.get("decode"), rec.get("forward"), rec.get("picks")))
        counts[key] = counts.get(key, 0) + 1
        if "vs_first_max_abs" in rec:
            largest[key] = [max(a, b) for a, b in zip(
                largest.get(key, [0.0, 0.0]), rec["vs_first_max_abs"])]
            vs_card[key] = [max(a, b) for a, b in zip(
                vs_card.get(key, [0.0, 0.0]), rec["vs_card_max_abs"])]
        emit({"probe": "cpu_process", "i": i, **rec}, out)
    emit({"probe": "cpu_processes", "n": n, "counts": counts,
          "first_parted_stages": parted, "usual_stages_known": bool(usual),
          "largest_vs_first_max_abs": largest,
          "largest_vs_card_max_abs": vs_card,
          "card": torch.cuda.get_device_name(0), "torch": torch.__version__},
         out)


def main() -> int:
    if "--cpu-once" in sys.argv:
        arg = lambda k: sys.argv[sys.argv.index(k) + 1] \
            if k in sys.argv else None  # noqa: E731
        print(json.dumps(cpu_once(arg("--save"), arg("--record"))),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("moe_f64_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu-processes", type=int, default=0)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "moe_f64_probe.jsonl"))
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.cpu_processes:
        cpu_processes(args.cpu_processes, args.out, args.record)
        return 0
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=N_LAYERS,
                              dtype="float64")
    masters = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                          "cuda")
    host = M._cast(tree_map(lambda a: a.cpu(), masters), torch.float64)
    card = M._cast(masters, torch.float64)
    del masters
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (BATCH, TOKENS)))
    stages = _Stages()

    def forward(p, t):
        stages.layer = -1
        return picks_of(lambda: M.forward(cfg, p, {"tokens": t}))

    t0 = time.perf_counter()
    with stages.installed(), _Record(stages) as rec:
        want, want_picks = forward(host, toks)
    with stages.installed(), _Record(stages, rec.ops) as again:
        cpu2, _ = forward(host, toks)
    emit({"probe": "cpu_twice", "ops": len(rec.ops),
          "max_abs_err": float((cpu2 - want).abs().max()),
          "op_diffs": again.diffs[:8], "unmatched": again.unmatched[:8],
          "cpu_s": time.perf_counter() - t0,
          "card": torch.cuda.get_device_name(0), "torch": torch.__version__},
         args.out)
    for rep in range(args.reps):
        kind = FILLS[rep % len(FILLS)]
        fill(kind)
        det = kind == "deterministic"
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            with stages.installed(), _Record(stages, rec.ops) as got:
                logits, picks = forward(card, toks.cuda())
        finally:
            torch.use_deterministic_algorithms(False)
        emit({"probe": "forward_ops", "rep": rep, "fill": kind,
              "max_abs_err": float((logits.cpu() - want).abs().max()),
              "picks_equal": len(picks) == len(want_picks) and all(
                  torch.equal(a, b) for a, b in zip(picks, want_picks)),
              "ops": len(got.ops), "ops_differing": len(got.diffs),
              "first_differing": got.diffs[:8],
              "unmatched": len(got.unmatched),
              "first_unmatched": got.unmatched[:8]}, args.out)
        del logits
    # the check as chip_smoke.py makes it: 16 decode steps and a forward
    B, S = toks.shape

    def decode_and_forward(p, t):
        dev = t.device
        full = M.forward(cfg, p, {"tokens": t})
        cache = M.init_cache(cfg, B, S, dev)
        dec = torch.stack([M.decode_step(
            cfg, p, cache, t[:, i:i + 1],
            torch.full((B,), i, device=dev))[0][:, 0] for i in range(S)], 1)
        return dec.cpu(), full.cpu()

    (cdec, cfull), cpicks = picks_of(lambda: decode_and_forward(host, toks))
    for rep in range(args.reps):
        kind = FILLS[rep % len(FILLS)]
        if kind != "deterministic":
            fill(kind)
        (dec, full), picks = picks_of(
            lambda: decode_and_forward(card, toks.cuda()))
        emit({"probe": "decode_and_forward", "rep": rep, "fill": kind,
              "decode_max_abs_err": float((dec - cdec).abs().max()),
              "forward_max_abs_err": float((full - cfull).abs().max()),
              "picks_equal": len(picks) == len(cpicks) and all(
                  torch.equal(a, b) for a, b in zip(picks, cpicks))},
             args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

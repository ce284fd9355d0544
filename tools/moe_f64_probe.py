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
"""
import argparse
import contextlib
import dataclasses
import json
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func).startswith(("aten.empty", "aten.new_empty")):
            return out                  # holds nothing yet
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            base = (self.stages.label(), str(func), tuple(t.shape),
                    str(t.dtype))
            n = sum(1 for key in self.ops if key[:4] == base)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_f64_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "moe_f64_probe.jsonl"))
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
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

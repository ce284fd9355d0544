#!/usr/bin/env python3
"""Runs the hybrid's decode checks of ``chip_smoke.py`` with a fault
planted in the decode path, to show what each check's limit catches.

    python3 tools/decode_fault_controls.py [--layers 12] [--every 6]

zamba2-2.7b at full width, cut to ``--layers`` in groups of ``--every``
(``chip_smoke.py``'s cut), on the card with TF32 off.  Each fault is
planted for the run by wrapping a function of the port in this process
(the checkout's files are not changed):

- ``ssm_state_bf16``: the Mamba-2 state ``ssm_h`` kept in bf16;
- ``kv_group_0``: every group's shared block reads and writes group 0's
  slice of the KV cache;
- ``conv_state_frozen``: the conv state is never shifted (it stays the
  empty state).

For no fault and each fault it prints one JSON line: the whole model's
readings (``gap_readings``: per dtype, decode against forward by
relative RMS and max abs, and the forward's own error), each dtype's
limit as ``chip_smoke.py`` sets it and whether the reading clears it,
and the worst block of ``hybrid_block_updates`` in f32 and in bf16
(max abs of the update's difference over its scale, and relative RMS).
Without a CUDA device it exits with 2.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

import chip_smoke as S                                        # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import model as M                     # noqa: E402

ARCH = "zamba2-2.7b"


@contextlib.contextmanager
def planted(fault):
    init_cache, causal_conv = M.init_cache, L._causal_conv

    def cache_with(cfg, batch, max_seq, device="cuda"):
        cache = init_cache(cfg, batch, max_seq, device)
        if fault == "ssm_state_bf16":
            cache["ssm_h"] = cache["ssm_h"].to(torch.bfloat16)
        if fault == "kv_group_0":
            for k in ("k", "v"):
                cache[k] = cache[k][:1].expand_as(cache[k])
        return cache

    def frozen(x, w, state):
        return causal_conv(x, w, state)[0], state

    M.init_cache = cache_with
    if fault == "conv_state_frozen":
        L._causal_conv = frozen
    try:
        yield
    finally:
        M.init_cache, L._causal_conv = init_cache, causal_conv


def worst_block(args, dtype):
    worst = {"over_scale": 0.0}
    for name, got, want in S.hybrid_block_updates(
            ARCH, args.layers, args.every, dtype):
        scale = max(1.0, float(want.abs().max()))
        err = float((got.float() - want.float()).abs().max()) / scale
        if err >= worst["over_scale"]:
            worst = {"block": name, "over_scale": err, "scale": scale,
                     "rel_rms": S.rel_rms(got, want)}
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--every", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_fault_controls: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ratios = {"float32": S.F32_GAP_RATIO,
              "bfloat16": S.HYBRID_BF16_GAP_RATIO}
    for fault in (None, "ssm_state_bf16", "kv_group_0",
                  "conv_state_frozen"):
        with planted(fault):
            r, (dec, full) = S.hybrid_decode_readings(ARCH, args.layers,
                                                      args.every)
            r["float64"]["limit"] = S.F64_TOL
            r["float64"]["caught"] = not bool(
                ((dec - full).abs() <= S.F64_TOL * (1 + full.abs())).all())
            for name, ratio in ratios.items():
                r[name]["limit"] = ratio * r[name]["error"]
                r[name]["caught"] = not r[name]["gap"] <= r[name]["limit"]
            blocks = {name: worst_block(args, S.DTYPES[name])
                      for name in ratios}
        print(json.dumps({"fault": fault, "n_layers": args.layers,
                          "attn_every": args.every, "model": r,
                          "worst_block": blocks,
                          "block_tol_f32": S.DECODE_TOL[torch.float32]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

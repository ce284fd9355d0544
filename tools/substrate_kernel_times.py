#!/usr/bin/env python3
"""Times the attention and selective-scan kernels of a checkout of the
port at the published widths of ``chip_smoke.py``, so that two checkouts
can be compared on one card in one run.

    python3 tools/substrate_kernel_times.py [--root CHECKOUT] [--reps N]

``--root`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: the one holding this script); its kernels are built there.
The cases, the inputs and the event timers are this checkout's
``chip_smoke.py`` (``attention_cases``, ``scan_cases``, ``event_ms``,
``cold_event_ms``), imported after the timed package, so that its
imports of ``repro_torch`` resolve to that package.  It prints one JSON
line: the card's name and power limit, ptxas's registers and spill
bytes of every instance of the two libraries, and for each case the
CUDA-event ms of the kernel warm (``ms``: back-to-back calls on the same
inputs) and, for attention, with the L2 made cold before each call
(``cold_ms``), its max abs error against the plain version, and the
bound of ``chip_smoke.py``.  Without a CUDA device it exits with 2.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("substrate_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import kernel as SS
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    assert Path(cs.FA.__file__).resolve().is_relative_to(root), cs.FA.__file__
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = {"flash_attention": FA.build_library(),
            "ssm_scan": SS.build_library()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    attn = {}
    for name, q, k, v, causal in cs.attention_cases(dev):
        fn = lambda: FA.flash_attention_kernel(  # noqa: E731
            q, k, v, causal=causal)
        err = float((fn().float() - attention_ref(
            q, k, v, causal=causal).float()).abs().max())
        attn[name] = {"ms": cs.event_ms(fn, args.reps),
                      "cold_ms": cs.cold_event_ms(fn, args.reps, flush),
                      "max_abs_err": err,
                      "bound_ms": cs.attention_bound(q, k, v, causal)[0]}
    del flush
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(smi.split(",")[2].split()[0])
    exp_per_s = sms * cs.SFU_EXP_PER_CLOCK_PER_SM * clock * 1e6
    scan = {}
    for name, a in cs.scan_cases(dev):
        fn = lambda: SS.selective_scan_kernel(*a)  # noqa: E731
        err = float((fn().float() - selective_scan_ref(*a).float())
                    .abs().max())
        scan[name] = {"ms": cs.event_ms(fn, args.reps), "max_abs_err": err,
                      "bound_ms": cs.scan_bound(a, exp_per_s)[0]}
    print(json.dumps({
        "tool": "substrate_kernel_times", "root": str(root), "card": smi,
        "torch": torch.__version__,
        "ptxas": {n: cs.ptxas_summary(b.log) for n, b in libs.items()},
        "attention": attn, "scan": scan}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training driver: the data pipeline, AdamW, checkpointing
and restart on a reduced LM, the twin of the reference's
``examples/train_lm.py``.  On the card::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30 \\
        --resume                                            # restart

and on the CPU with ``--device cpu``.  The weights are random, drawn
from a ``torch.Generator`` seeded 0 (not the reference's draws).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from ..checkpoint import latest_step, restore, save
from ..configs import get_arch, reduced_config
from ..configs.base import ShapeConfig
from ..core.backends.cuda import check_device
from ..data import DataConfig, SyntheticTokenPipeline
from ..models.params import init_params, tree_leaves
from ..optim import AdamWConfig
from ..optim.adamw import init_opt_state
from ..train import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the driver; returns the loss of every step it ran."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="build/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model", type=int, default=256,
                    help="width of the reduced config (~10M params; use "
                         "512+ for the ~100M regime)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    cfg = reduced_config(get_arch(args.arch))
    cfg = dataclasses.replace(cfg, d_model=args.d_model,
                              n_layers=args.layers,
                              d_ff=args.d_model * 4 if cfg.d_ff else 0,
                              d_head=max(16, args.d_model // max(cfg.n_heads,
                                                                 1)),
                              vocab=2048)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    pipe = SyntheticTokenPipeline(cfg, shape, DataConfig(seed=0))
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=20,
                                               total_steps=args.steps))

    start = 0
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt_state(params)
    if args.resume:
        last = latest_step(args.ckpt)
        if last is not None:
            state = restore(args.ckpt, last, {"params": params, "opt": opt},
                            dev)
            params, opt = state["params"], state["opt"]
            start = last
            print(f"resumed from step {last}")

    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")
    losses = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = pipe.device_batch(step, dev)
        params, opt, info = step_fn(params, opt, batch)
        loss = float(info["loss"])
        losses.append(loss)
        dt = time.time() - t0
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={loss:.4f} "
                  f"gnorm={float(info['grad_norm']):.3f} {dt:5.2f}s")
        if (step + 1) % args.ckpt_every == 0:
            save(args.ckpt, step + 1, {"params": params, "opt": opt})
            print(f"  checkpoint @ {step + 1}")
    print("done.")
    return losses


if __name__ == "__main__":
    main()

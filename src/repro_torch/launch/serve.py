"""Production serving launcher: batched decode with the DSMS query engine
(the twin of ``python -m repro.launch.serve``).

Every decoder architecture of ``repro_torch.configs`` serves (the
dense, vlm, moe, ssm and hybrid families; the encoder-only
hubert-xlarge has no decode step).  On the card (the default)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --batch 4 --max-seq 1024 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --batch 4 --max-seq 1024 --steps 32

and on the CPU, at a reduced size::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --reduced --device cpu --steps 2

Weights are random, drawn from ``--seed``.  Steps are timed with CUDA
events on the card and with the host clock on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_arch, reduced_config
from ..configs.base import ModelConfig
from ..core.backends.cuda import check_device
from ..models.params import init_params
from ..serve import DSMSEngine, Query


def default_queries() -> List[Query]:
    """The launcher's two continuous queries: the top token's softmax
    confidence, and the top 5 logits with an optional sorted refinement
    that runs only inside its schedule hole."""
    return [
        Query("argmax_conf",
              mandatory=lambda lg: torch.softmax(lg[:, -1], dim=-1)
              .max(dim=-1).values),
        Query("topk",
              mandatory=lambda lg: torch.topk(lg[:, -1], 5),
              optional=lambda r: (r[0], r[1],
                                  torch.sort(r[0]).values.flip(-1)),
              optional_ratio=0.5),
    ]


def build_engine(cfg: ModelConfig, batch: int, max_seq: int, seed: int = 0,
                 device: str = "cuda",
                 sched_backend: Optional[str] = None) -> DSMSEngine:
    """A :class:`DSMSEngine` over random weights drawn from ``seed`` on
    ``device``, with :func:`default_queries` registered.  The f32 masters
    are dropped once the engine holds its copy in the config's dtype."""
    dev = check_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    eng = DSMSEngine(cfg, params, batch_size=batch, max_seq=max_seq,
                     backend=sched_backend, device=dev)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for q in default_queries():
        eng.register(q)
    return eng


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--sched-backend", type=str, default=None,
                    choices=["cuda", "scalar"],
                    help="candidate-evaluation backend of the DSMS static "
                         "scheduler (default: cuda)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the model and the scheduler run")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if not cfg.decoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no serve step")
    eng = build_engine(cfg, args.batch, args.max_seq, args.seed,
                       args.device, args.sched_backend)
    eng.ensure_plan()
    print(f"{cfg.name}: {len(eng.queries)} registered queries, plan "
          f"makespan {eng.plan.makespan*1e3:.3f} ms")
    toks = np.zeros(args.batch, np.int64)
    on_card = eng.device.type == "cuda"
    if on_card:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        res = eng.step(toks)
        toks = res.tokens
    if on_card:
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / args.steps
    else:
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"{args.steps} steps, {ms:.1f} ms/step (batch {args.batch}, "
          f"{'CUDA events' if on_card else 'host clock'}); "
          f"last tokens {toks.tolist()}")


if __name__ == "__main__":
    main()

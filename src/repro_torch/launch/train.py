"""Training launcher, the twin of ``python -m repro.launch.train``: the
architecture's config, random f32 master weights from ``--seed``, the
synthetic data pipeline, the train step (remat on, ``--microbatch``
accumulation) and AdamW, with checkpoints and restart.  On the card (the
default)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 20 --batch 4 --seq 4096 --microbatch 2

and on the CPU, at a reduced size, saving every 3 steps and resuming
from the latest checkpoint::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --device cpu --steps 6 --ckpt ckpt --ckpt-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --device cpu --steps 6 --ckpt ckpt --ckpt-every 3 \\
        --resume

Every step's loss and grad norm are printed.  The model trains on a
DeviceMesh, ``--mesh DxM`` (data x model) or ``PxDxM`` (pod x data x
model), the reference's axis names: every parameter, optimizer leaf and
batch input is a DTensor laid out by the reference's rules, and
``--resume`` restores onto the mesh, whatever mesh saved the checkpoint.
Under ``torchrun`` the process group comes from the environment (gloo
with ``--device cpu``, NCCL on the cards, one rank per card); run alone
the launcher makes a one-rank group of its own.  Four CPU ranks::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --mesh 2x2 --steps 6
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import latest_step, restore, save
from ..configs import get_arch, reduced_config
from ..configs.base import ModelConfig, ShapeConfig
from ..core.backends.cuda import check_device
from ..data import DataConfig, SyntheticTokenPipeline
from ..models.params import Tree, distribute_params, init_params, \
    param_shardings, tree_leaves
from ..models.sharding import use_sharding
from ..optim.adamw import AdamWConfig, OptState, init_opt_state
from ..train import make_train_step
from ..train.step import batch_shardings, opt_shardings
from .mesh import make_mesh


def init_state(cfg: ModelConfig, seed: int = 0,
               device: str = "cuda") -> Tuple[Tree, OptState]:
    """Random f32 master weights drawn from ``seed`` on ``device``, and a
    fresh optimizer state; under an active mesh every leaf a DTensor
    (each rank draws the whole tree and keeps its shards)."""
    dev = check_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    params = distribute_params(cfg, params)
    return params, init_opt_state(params)


def resume(ckpt: str, params: Tree, opt: OptState, device: str = "cuda",
           placements: Optional[Dict] = None
           ) -> Tuple[Tree, OptState, int]:
    """The latest checkpoint under ``ckpt`` and its step, or the state
    given and step 0 when there is none; with ``placements`` (``{"p":
    ..., "o": ...}``) laid out on the active mesh."""
    last = latest_step(ckpt)
    if last is None:
        return params, opt, 0
    st = restore(ckpt, last, {"p": params, "o": opt}, device, placements)
    return st["p"], st["o"], last


def train_loop(step_fn: Callable, pipe: SyntheticTokenPipeline,
               params: Tree, opt: OptState, start: int, stop: int,
               device: str = "cuda", ckpt: str = "", ckpt_every: int = 50,
               log: Optional[Callable[[str], None]] = print,
               placements: Optional[Dict] = None
               ) -> Tuple[Tree, OptState, List[dict]]:
    """Steps ``start`` to ``stop - 1`` on the pipeline's batches (laid out
    by ``placements``, ``batch_shardings``, under a mesh), saving
    ``{"p": params, "o": opt}`` under ``ckpt`` after every
    ``ckpt_every``-th step.  Returns the state and each step's metrics
    (loss, grad norm, lr; Python floats)."""
    infos = []
    for s in range(start, stop):
        t0 = time.perf_counter()
        params, opt, info = step_fn(params, opt,
                                    pipe.device_batch(s, device, placements))
        info = {k: float(v) for k, v in info.items()}
        infos.append(info)
        if log is not None:
            log(f"step {s:5d} loss={info['loss']:.4f} "
                f"gnorm={info['grad_norm']:.3f} "
                f"({time.perf_counter() - t0:.2f}s)")
        if ckpt and (s + 1) % ckpt_every == 0:
            save(ckpt, s + 1, {"p": params, "o": opt})
    return params, opt, infos


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the launcher; returns the loss of every step it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model) or PxDxM for multi-pod; its "
                         "size is the process group's")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="parsed and never read, as in the reference "
                         "launcher: the train step does not compress")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the data")
    args = ap.parse_args(argv)
    dims = [int(x) for x in args.mesh.split("x")]
    axes = ("pod", "data", "model")[-len(dims):]
    own = start_group(args.device)
    try:
        mesh = make_mesh(dims, axes, torch.device(args.device).type)
        with use_sharding(mesh):
            return _train(args, dict(zip(axes, dims)))
    finally:
        if own:
            dist.destroy_process_group()


def start_group(device: str) -> bool:
    """Starts the default process group unless one is running: from
    ``torchrun``'s environment (NCCL on the cards, the rank's own card;
    gloo on the CPU), else a one-rank group of this process.  Returns
    whether it started one."""
    if dist.is_initialized():
        return False
    cuda = check_device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if "WORLD_SIZE" in os.environ:
        if cuda:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _train(args: argparse.Namespace, mesh_shape: Dict[str, int]
           ) -> List[float]:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    pipe = SyntheticTokenPipeline(cfg, shape, DataConfig(seed=args.seed))
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=args.steps),
                              microbatch=args.microbatch)
    log = print if dist.get_rank() == 0 else None
    params, opt = init_state(cfg, args.seed, args.device)
    start = 0
    if args.resume and args.ckpt:
        params, opt, start = resume(
            args.ckpt, params, opt, args.device,
            {"p": param_shardings(cfg), "o": opt_shardings(cfg)})
        if start and log:
            log(f"resumed @ {start}")
    n = sum(p.numel() for p in tree_leaves(params))
    if log:
        log(f"{cfg.name}: {n / 1e6:.1f}M params on {args.device}, mesh "
            f"{mesh_shape}")
    # one step a call: the state this frame holds is each step's own
    # input, never the first step's for the whole run
    infos: List[dict] = []
    for s in range(start, args.steps):
        params, opt, got = train_loop(step_fn, pipe, params, opt, s, s + 1,
                                      args.device, args.ckpt,
                                      args.ckpt_every, log,
                                      batch_shardings(cfg, shape))
        infos += got
    if log:
        log("done.")
    return [i["loss"] for i in infos]


if __name__ == "__main__":
    main()

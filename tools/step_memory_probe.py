#!/usr/bin/env python3
"""One train step of the launcher's mesh path on the card, its memory
held against the dry run's accounting of the same step.

    python3 tools/step_memory_probe.py [--steps N] [--tf32-off]

On a one-rank NCCL group and a (1, 1) DeviceMesh, qwen2-0.5b at full
size (``chip_smoke.py``'s train cell: seq 4096, batch 4 in 2
microbatches, remat on, f32 masters from seed 0): ``init_state``, one
warm step (``--steps N``: N, the peak read after each; ``--tf32-off``:
TF32 off first, as ``chip_smoke.py`` sets it), then one step under two
dispatch modes below DTensor:
``launch/dryrun.py``'s live-bytes accounting over the card's own tensors
(the dry run's rule applied to real storages), and a per-op reading of
the allocator (its peak inside each op, less what is allocated when the
op returns: the op's internal temporaries, which an op on meta tensors
never allocates).  It then runs ``launch.dryrun.step_memory`` on the
same step over meta tensors, in a process that sees no card.  Prints
one JSON line: ``torch.cuda.max_memory_allocated`` from before
``init_state`` and over the probed step, the step's start, the
accounting's peak on the card and on meta, and the ops with the largest
internal temporaries.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import (init_state, start_group,  # noqa: E402
                                      train_loop)
from repro_torch.models.sharding import use_sharding  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import batch_shardings  # noqa: E402

ARCH, SEQ, BATCH, MICRO = "qwen2-0.5b", 4096, 4, 2
META = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
D.fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
print(json.dumps(D.step_memory(sys.argv[2], ShapeConfig(
    "train", int(sys.argv[3]), int(sys.argv[4]), "train"), mesh,
    microbatch=int(sys.argv[5]))))
"""


class _OpTemps(TorchDispatchMode):
    """Per local op: the allocator's peak inside it and its temporaries
    (that peak less what is allocated when it returns); at the op that
    sets the step's peak, that op and the accounting's live bytes."""

    def __init__(self, live) -> None:
        super().__init__()
        self.live = live
        self.peak = 0
        self.at_peak = {}
        self.temps = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        torch.cuda.reset_peak_memory_stats()
        live0 = self.live.live
        out = func(*args, **(kwargs or {}))
        p = torch.cuda.max_memory_allocated()
        name = str(func)
        if p > self.peak:
            self.peak = p
            self.at_peak = {"op": name, "allocator_bytes": p,
                            "live_before_op_bytes": live0,
                            "live_after_op_bytes": self.live.live}
        temp = p - torch.cuda.memory_allocated()
        if temp > self.temps.get(name, 0):
            self.temps[name] = temp
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("step_memory_probe: no CUDA device", file=sys.stderr)
        return 2
    if "--tf32-off" in sys.argv:         # as chip_smoke.py sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    steps = int(sys.argv[sys.argv.index("--steps") + 1]) \
        if "--steps" in sys.argv else 1
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    meta = subprocess.Popen(
        [sys.executable, "-c", META, str(ROOT / "src"), ARCH, str(SEQ),
         str(BATCH), str(MICRO)], stdout=subprocess.PIPE, text=True,
        env=env)
    cfg = get_arch(ARCH)
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    pipe = SyntheticTokenPipeline(cfg, shape)
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=8),
                              microbatch=MICRO)
    own = start_group("cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with use_sharding(mesh):
            params, opt = init_state(cfg, 0, "cuda")
            place = batch_shardings(cfg, shape)
            init_peak = torch.cuda.max_memory_allocated()
            step_peaks = []
            for s in range(steps):
                params, opt, _ = train_loop(step_fn, pipe, params, opt, s,
                                            s + 1, "cuda", log=None,
                                            placements=place)
                torch.cuda.synchronize()
                step_peaks.append(torch.cuda.max_memory_allocated())
            warm_peak = step_peaks[0]
            batch = pipe.device_batch(1, "cuda", place)
            args = (params, opt, batch)
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            arg_bytes = D._nbytes(D._locals(*args))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with D._LiveBytes(D._locals(*args)) as live, \
                    _OpTemps(live) as ops:
                params, opt, info = step_fn(*args)
                loss = float(info["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del args, batch
    finally:
        if own:
            dist.destroy_process_group()
    out, _ = meta.communicate(timeout=600)
    dry = json.loads(out.strip().splitlines()[-1])
    top = sorted(ops.temps.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "arch": ARCH, "seq": SEQ, "batch": BATCH, "microbatch": MICRO,
        "card": torch.cuda.get_device_name(0), "loss": loss,
        "max_memory_allocated_init_bytes": init_peak,
        "max_memory_allocated_first_step_bytes": warm_peak,
        "max_memory_allocated_after_each_step_bytes": step_peaks,
        "tf32_off": "--tf32-off" in sys.argv, "op_at_peak": ops.at_peak,
        "step_start_allocated_bytes": start, "step_arg_bytes": arg_bytes,
        "step_allocator_peak_bytes": ops.peak,
        "step_live_peak_on_card_bytes": live.peak,
        "step_live_peak_plus_other_bytes": live.peak + start - arg_bytes,
        "dryrun_meta": dry, "step_wall_s": wall,
        "largest_op_temporaries": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

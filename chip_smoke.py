#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the kernels of the port with ``nvcc``, one process per
source, all started together: the scheduling kernels (``src/repro_torch/
core/backends/csrc``, with ``--fmad=false``) and the attention and scan
kernels (``src/repro_torch/kernels/csrc``).  It holds the scheduling
kernels against their plain PyTorch versions on the card (exact
equality of every output), drives the scheduler's main path —
``Scheduler.submit`` on the paper's worked example and on the exp7
deployment (16 ECUs, 500 tasks, the 301-alpha HVLB_CC grid in one
kernel launch) — and checks the results against the pinned paper
numbers and the port's scalar reference.  It drives the session's
replanning loop at exp7 (probe_update and update of a late and a
mid-queue task, a batch of three events, a link-speed change; four of
its resumed plan launches, each from the state of a replayed prefix, are
held exactly to the plain version on the same inputs), the fault
methods (the paper example's drill, 65 -> 89 with processor 2 down, and
mark_failed / degrade / restore at the exp9 deployment, 8 ECUs and 240
tasks) and the scheduler service (``repro_torch.service``, the exp10
trace of 8 tenants with coalescing on and off), all on the card, and
holds every plan bit for bit to the port's scalar session on the same
calls (a fault replan also to a fresh session started with its faults,
a service fleet to a scalar ``submit_many`` of the final state).  Phase
``backend_auto`` runs the paper submits and the exp9 fault script under
``backend="auto"`` (scalar at P 3, vector at P 8) and ``"vector"``
beside a ``"cuda"`` session, every host plan bit for bit to the card's,
and prints each backend's wall seconds.  Phase ``f32_mode`` runs the
device backend in float32 (``dtype=torch.float32``, the reference's TPU
numerics): both kernels' float32 instantiations held bit for bit to
their float32 plain versions at the paper instance and at exp7 (waves,
the 301-alpha plan) and timed at exp7; the paper's submits and fault
drill in float32 with float64's placements; the exp7 submit beside
float64's, with how many of its 301 alphas decide as float64 does and,
where one parts, the relative gap of the two float64 values that
decided there, which must lie under the near-tie band
``F32_NEAR_TIE_RTOL``; the exp9 fault script in float32 without
violations at float32's slack (``FLOAT32_RTOL``); and the three examples
of ``repro_torch.examples`` on the card, each in a process of its own.
Every float64 path launches no float32 instantiation and every float32
path only those.  It
then drives the kernel entry points (``repro_torch.kernels.*.ops``) at
published model widths — attention at qwen3-8b, qwen2-0.5b and
hubert-xlarge width (each in bf16 and in f32), the selective scan at
falcon-mamba-7b width, S = 4096 — and holds each output against the
plain version on the card at the tolerances of
``tests/test_kernels.py``, with the plain versions in full f32 (TF32
off); attention is also held to a relative RMS error per block of 64
query rows, a limit that a control dropping one kv tile must exceed.
Last it drives the DSMS serving path of ``python -m
repro_torch.launch.serve`` (phase ``serve``): qwen3-8b at full size
(36 layers, d_model 4096, random bf16 weights from a seed, batch 4, a KV
cache of 1024 positions) through ``DSMSEngine``, whose plan, ``retime``
and ``mark_failed`` replans go through ``sched_plan_kernel`` and are
held bit for bit to a scalar session on the same calls, and
``sched_plan_kernel`` is held exactly to its plain version on the
serving instance's 21-alpha grid and on the replans' resumed launches;
it times 32 decode steps with CUDA events beside the step's byte bound,
reads the device's busy time a step from a torch.profiler trace of 4
more, checks every logit finite and every token in the vocabulary, and
holds
``decode_step`` against ``forward`` at full width (2 layers) in bf16 at
2e-2 and in f32 (TF32 off) at 1e-4.  Phase ``serve_families`` drives
the same path at olmoe-1b-7b (moe), falcon-mamba-7b (ssm) and
zamba2-2.7b (hybrid), each at full size (16 timed steps, 2 profiled),
then holds each family's decode at full width: falcon-mamba's
``decode_step`` against ``forward`` (2 layers; bf16 2e-2, f32 1e-4),
zamba2's (12 layers in 2 groups of 6) in f64 elementwise and in f32 and
bf16 by relative RMS against the forward's own error in that dtype
(then block by block in f32), olmoe's (2 layers) on the card against
the CPU in f64 and f32 with every MoE call's routing equal, and
dbrx-132b's MoE layer alone at full width (card against CPU, a
decode-sized and a prefill-sized group; the model does not fit one
card).  Phase ``train`` drives the training path of ``python -m
repro_torch.launch.train`` (``init_state``, the synthetic pipeline,
``make_train_step``, ``train_loop``) at qwen2-0.5b's full size (24
layers, d_model 896, random f32 masters from a seed, bf16 compute), seq
4096, global batch 4 in 2 microbatches, remat on: 5 steps timed with
CUDA events after 2 warm-up (ms a step, tokens/s, model FLOPs and their
share of the bf16 peak, ``mfu``, peak memory), one more under
torch.profiler (device busy, kernels a step); every loss and grad norm
finite.  It restarts at full size (3 steps, a save and a restore
through the port's checkpoint, 3 more) against the straight run's
losses at rtol 1e-5, and holds one train step on the card against the
CPU at full width (2 layers, batch 2, seq 512) for qwen2-0.5b and
olmoe-1b-7b: the loss, every gradient and every updated parameter in
f64 elementwise at 1e-9, and in f32 (TF32 off) by relative RMS within
``F32_GAP_RATIO`` times the CPU's own f32 error, with the MoE's routing
equal in f64 (the f32 runs take the f64 picks).  Phase ``mesh`` drives
the sharding path: the launcher's ``--mesh 1x1`` (a one-rank NCCL
group, a DeviceMesh, every parameter, optimizer leaf and batch input a
DTensor) for 3 steps at the train phase's size and seed, held to the
train phase's first steps (losses at the restart rtol, grad norms at
1e-3, and whether each is bit for bit) with ms a step beside the
mesh-less step, then a save and a restore of its state through the
sharded checkpoint (every leaf bit-equal, the seconds of each, the
save's device peak within 64 MiB of the bytes allocated before it); the
loss head against ``torch.logsumexp`` and
``gather`` bit for bit; the dry run (``launch/dryrun.py``) at full size
on meta tensors in a process that sees no card (dbrx-132b decode_32k on
the 16 x 16 pod, dbrx-132b train_4k on the 2 x 16 x 16 multi-pod,
qwen3-8b train_4k on the pod: each rank's state under the card's
memory, each cell's peak with activations beside it, no all-gather of
a train cell's logits), and the dry run's peak of the launcher's own
step on a (1, 1) mesh against the bytes the card allocated for it
(within 0.85-1.15); and 4 CPU ranks (gloo,
2 x 2) at full width, 2 layers, f64, one train step of qwen2-0.5b and
olmoe-1b-7b held to the same step on one rank (the card, no mesh) at
1e-10 relative by norm.
bf16 attention must go to the tensor-core kernel and f32 to the
CUDA-core one, bf16 with q, k and v scaled by 8 must hold the elementwise
bf16 tolerance, and each attention case is timed warm and with the L2
made cold before every call.  ptxas must report no spill in any
instance of the scheduling, attention and scan kernels.  Each path is
driven with every launch count at 0 just before it and read just after.
It prints one JSON line per phase, then the
``kernels`` line (every kernel: launches on its path, error, times,
bound; f32 attention has an entry of its own), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  The
``kernel_times`` line gives each scheduling kernel at exp7 the CUDA-event
time around back-to-back wrapper calls (``ms``, as every earlier run
timed it), its device time with the host's enqueue hidden
(``device_ms``), ``us_per_decision`` (plan: ms * 1000 / (A * W * B),
spread over the blocks running in parallel; wave: ms * 1000 / B), for
the plan ``us_per_decision_in_series`` (ms * 1000 / (W * B), a block's
chain of decisions) and for the wave ``device_us_per_decision``
(device_ms * 1000 / B), the plain version's time, the bytes it must
move and its bound; ``main_exp7`` adds the plan
kernel's output bytes and ``torch.cuda.max_memory_allocated()`` over the
submit.  Any failure raises, and the exit code is not 0;
without a CUDA device it exits with 2 before printing any result.
"""
import asyncio
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.core import (HSV_CC, HVLB_CC_B, HVLB_CC_IC,  # noqa: E402
                              DEFAULT_BATCH_MAX, FLOAT32_RTOL,
                              CompiledInstance,
                              CudaBackend, LinkDegraded, LinkDown,
                              ProcessorDown, Scheduler,
                              fully_switched_topology, hprv_b, paper_spg,
                              paper_topology, plan_waves, priority_queue,
                              random_spg, rank_matrix, schedule_violations)
from repro_torch.service import SchedulerService  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.backends import cuda as K  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as SS  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.checkpoint import restore as ckpt_restore  # noqa: E402
from repro_torch.checkpoint import save as ckpt_save  # noqa: E402
from repro_torch.checkpoint.checkpoint import \
    _paths as ckpt_paths  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.launch.train import (init_state, resume,  # noqa: E402
                                      start_group, train_loop)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.sharding import full, use_sharding  # noqa: E402
from repro_torch.train.step import (batch_shardings,  # noqa: E402
                                    opt_shardings)
from repro_torch.models.params import param_shardings  # noqa: E402
from repro_torch.models import (distribute_params,  # noqa: E402
                                init_params, param_specs, tree_leaves)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import tree_map  # noqa: E402
from repro_torch.optim import (AdamWConfig, OptState,  # noqa: E402
                               adamw_update, init_opt_state)
from repro_torch.train import loss_and_grads, make_train_step  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 (non-tensor)
# peaks, dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# exps per clock per SM of the special-function units (Hopper)
SFU_EXP_PER_CLOCK_PER_SM = 16

# the tolerances of tests/test_kernels.py
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# the limit of an attention output's relative RMS error in every block of
# 64 query rows of a head (block_rel_rms), which scales with the data
# where the elementwise tolerance above does not: it lies between the
# largest reading of sound runs and the reading of a control that drops
# one kv tile (tile_drop_rms), both in PERF.md; tests/test_torch_gpu.py
# holds the card tests to the same limits
ATTN_RMS_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

PAPER_POLICY = dict(alpha_max=3.0, period=150.0)
EXP7_POLICY = HVLB_CC_B(alpha_max=3.0, alpha_step=0.01)
# the exp9 and exp10 deployments (benchmarks/exp9_faults.py,
# benchmarks/exp10_service.py): P = 8 switched ECUs; exp9's index 7 is a
# cold standby (rate 0.3)
EXP9_RATES = [1.0, 1.2, 0.9, 1.1, 1.3, 0.95, 1.05, 0.3]
EXP10_RATES = [1.0, 1.2, 0.9, 1.1, 1.3, 0.95, 1.05, 0.8]
EXP9_10_SPEEDS = [1.0, 2.0, 1.5, 1.0, 3.0, 2.5, 1.0, 2.0]
EXP9_POLICY = HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)   # exp10's too
# the serve phase: python -m repro_torch.launch.serve at qwen3-8b, full
# size, batch 4, 1024 positions of KV cache; 2 warm-up and 32 timed steps
SERVE_ARCH = "qwen3-8b"
# the serve_families phase: the same at olmoe-1b-7b, falcon-mamba-7b and
# zamba2-2.7b (layers, d_model), 16 timed steps and 2 profiled
FAMILY_ARCHS = {"olmoe-1b-7b": (16, 2048), "falcon-mamba-7b": (64, 4096),
                "zamba2-2.7b": (54, 2560)}
FAMILY_STEPS, FAMILY_PROFILED_STEPS = 16, 2
SERVE_BATCH, SERVE_MAX_SEQ = 4, 1024
SERVE_WARMUP, SERVE_STEPS = 2, 32
# then 4 more under torch.profiler, for the device's busy time a step
SERVE_PROFILED_STEPS = 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# decode_step against forward at full width: bf16 at the reference's own
# 2e-2 (tests/test_smoke_archs.py); f32 (TF32 off) at 1e-4, PERF.md §6
DECODE_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The random hybrid and MoE models at full width lack a q/k norm, and
# their attention scores reach the hundreds at the reference's init, so
# two f32 evaluations of one function (decode against forward, the card
# against the CPU) differ elementwise by more than 1e-4 (PERF.md).  Such
# a pair is held in f64 elementwise at F64_TOL, where the gap is
# rounding of 1e-13, and in f32 by relative RMS to F32_GAP_RATIO times
# the f32 error of the side it is compared with (that side's f32 logits
# against its f64 logits on the same masters): two independent roundings
# of that size give ~1.4, and tests/test_torch_models.py::
# test_f32_gap_ratio_{hybrid_full_width,moe} read 0.34-1.23 on the CPU,
# the reference's own decode included.
F64_TOL = 1e-9
F32_GAP_RATIO = 3.0
# the bf16 hybrid's decode against its forward, held by relative RMS to
# this multiple of the model's own bf16 error on the same weights (its
# bf16 forward against its f32 one); set from the reference's own gap,
# 0.28-0.97 of that error (tests/test_torch_models.py::
# test_reference_hybrid_bf16_decode_gap)
HYBRID_BF16_GAP_RATIO = 1.5
# the train phase: python -m repro_torch.launch.train's path at
# qwen2-0.5b, full size, random f32 masters from seed 0, bf16 compute,
# seq 4096 (train_4k's length), global batch 4 in 2 microbatches, remat
# on; 2 warm-up steps, 5 timed, 1 under torch.profiler
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_MICROBATCH = 4, 2
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# the restart check: 3 steps, a save and a restore, 3 more, against the
# straight run's steps at the rtol of the reference's
# test_train_restart_exact
TRAIN_RESTART, TRAIN_RESTART_RTOL = 3, 1e-5
# one train step on the card against the CPU: full width, cut to 2
# layers, batch 2, seq 512
TRAIN_PARITY = ("qwen2-0.5b", "olmoe-1b-7b")
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 512
# the mesh phase: the launcher's path (--mesh 1x1) on a one-rank NCCL
# DeviceMesh at the train phase's size and seed, MESH_STEPS steps held to
# the train phase's first steps: losses at the restart check's rtol (the
# same steps from the same state), grad norms at MESH_GNORM_RTOL (the
# step's gradient at full width is chaotic, ROADMAP.md section 3: a
# reordered sum would move it far more than the loss); both bit for bit
# where DTensor dispatches the same local ops, which the line reports
MESH_STEPS, MESH_GNORM_RTOL = 3, 1e-3
# the checkpoint after the mesh steps: the save's device peak may exceed
# the bytes allocated before it by no more than this (no leaf is copied
# on the card; the host copies are pageable)
MESH_CKPT_SLACK = 64 << 20
# the dry run's peak of the launcher's own step over meta tensors against
# the bytes the card allocated for the launcher
DRYRUN_PEAK_RATIO = (0.85, 1.15)
# the backend names a session accepts besides the default: each runs
# the paper submits and the exp9 fault script (phase backend_auto)
BACKEND_NAMES = ("cuda", "auto", "vector")
# phase f32_mode: the device backend in float32 (the reference's TPU
# numerics); a plan that parts from the float64 plan must part at a
# near-tie, two values within this relative gap (the reference's
# F32_NEAR_TIE_RTOL)
F32 = torch.float32
# the examples of the port (python -m repro_torch.examples.<name>), each
# run on the card at its default size in a process of its own
EXAMPLES = (("quickstart", []),
            ("dsms_serve", []),
            ("train_lm", ["--ckpt", "build/example_ckpt"]))
EXAMPLE_TIMEOUT_S = 300
# the dry run at full size on meta tensors (fake groups of 256 and 512
# ranks), each rank's bytes under the card's memory
DRYRUN_CELLS = (("dbrx-132b", "decode_32k", "pod"),
                ("dbrx-132b", "train_4k", "multipod"),
                ("qwen3-8b", "train_4k", "pod"))
# 4 CPU ranks (gloo) on a 2 x 2 mesh at full width, cut to 2 layers, f64:
# one train step (remat off: it changes no value and costs a forward)
# held to the same step on one rank without a mesh at MESH_CPU_RTOL,
# relative by norm (the mesh only reorders f64 sums)
MESH_CPU_ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")
MESH_CPU_LAYERS, MESH_CPU_BATCH, MESH_CPU_SEQ = 2, 4, 256
MESH_CPU_RTOL = 1e-10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def exp7_instance():
    """The exp7 deployment: a 16-ECU single-switch star and a 500-task
    TGFF graph (benchmarks/exp7_engine_scaling.py, P = 16, n = 500)."""
    rng = np.random.default_rng(77)
    P = 16
    tg = fully_switched_topology(P, rates=rng.uniform(0.6, 1.2, size=P),
                                 link_speeds=rng.uniform(0.5, 3.0, size=P))
    g = random_spg(500, np.random.default_rng(7000 + 500 + P), ccr=1.0,
                   tg=tg, max_in=3, max_out=6)
    return g, tg


def queue_of(g, tg):
    r = rank_matrix(g, tg)
    return r, priority_queue(hprv_b(g, tg, r), r.mean(1))


def compare(name, got, want) -> float:
    """Exact equality of every output tensor; returns the max abs error
    over the entries that are finite in both (0.0 when equal)."""
    err = 0.0
    for k, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: output {k} shape/dtype "
                                 f"{x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        if x.dtype.is_floating_point:
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x[fin] - y[fin]).abs().max()))
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: kernel output {k} differs from "
                                 f"the plain version (max abs err {err})")
    return err


def nbytes(ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def table_bytes(T, task, edge, src) -> int:
    """Bytes of the instance tables that decisions of ``task`` with
    predecessor rows ``(edge, src)`` read, each distinct row once: the CT
    row of every (edge, source processor) pair, the link-id, valid and
    hop-count planes of every source processor (padding predecessors read
    the pad row and plane), and the comp and LDET rows of every task."""
    P, R, H = T.P, T.R, T.H
    src = src.long()
    pairs = torch.unique(edge.long() * (P + 1) + src).numel()
    srcs = torch.unique(src).numel()
    tasks = torch.unique(task).numel()
    return (pairs * R * H * P * T.ct.element_size()
            + srcs * (R * H * P * T.lid.element_size()
                      + R * P * (T.valid.element_size()
                                 + T.nhops.element_size()))
            + tasks * P * (T.comp.element_size() + T.ldet.element_size()))


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> float:
    """CUDA-event ms per call of ``fn`` with the host's enqueue hidden:
    a spin kernel holds the stream while the host enqueues all ``reps``
    calls, so the events bracket the device's work alone, not the time
    the wrapper spends on the host (which ``event_ms`` reads when it
    exceeds the kernel's).  The spin is doubled until it outlasts the
    enqueue; ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(12):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if s.elapsed_time(a) > enqueue_ms:
            return a.elapsed_time(b) / reps
        cycles *= 2
    raise RuntimeError("the spin kernel never outlasted the enqueue")


def bound(bytes_moved: int, ops: int, ops_per_s: float = FP64_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_all_launches() -> None:
    for mod in (K, FA, SS):
        mod.reset_launches()


def all_launches() -> dict:
    """Every kernel's launch count, the scheduling kernels' float32
    launches (``sched_wave_kernel/f32``, ``sched_plan_kernel/f32``), and
    the attention launches split by the kernel they went to
    (``flash_attention_kernel/wgmma_bf16``, ``.../fma_f32``)."""
    return {**K.LAUNCHES,
            **{f"{k}/f32": n for k, n in K.F32_LAUNCHES.items()},
            **FA.LAUNCHES,
            **{f"flash_attention_kernel/{k}": n
               for k, n in FA.VARIANT_LAUNCHES.items()}, **SS.LAUNCHES}


def ptxas_summary(log: str) -> dict:
    """Registers and spill stores of each kernel nvcc compiled, from the
    ``-Xptxas=-v`` output: {mangled name: [registers, spill bytes]}."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), spill]
            name, spill = None, 0
    return out


def attention_ptxas(log: str) -> dict:
    """ptxas's lines for each attention kernel instance, keyed
    ``wgmma_bf16<d>`` (tensor cores) or ``fma_f32<d>`` (CUDA cores):
    registers, stack and spills, and any note that names the instance
    (e.g. C7512: wgmma serialized)."""
    def key(line):
        m = re.search(r"flash_attention_(wgmma_)?kernelI(?:f)?Li(\d+)E", line)
        return m and f"{'wgmma_bf16' if m.group(1) else 'fma_f32'}" \
            f"<{m.group(2)}>"
    out, name = {}, None
    for line in log.splitlines():
        k = key(line)
        if "Compiling entry function" in line:
            name = k
            if k:
                out.setdefault(k, [])
        elif k and re.search(r"\(C\d+\)", line):
            note = re.split(r" (?:in|for) the function| in function", line)
            out.setdefault(k, []).append(note[0].strip())
        elif name and ("bytes stack frame" in line or "Used" in line):
            out[name].append(line.strip())
    return out


def cold_event_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of ``fn`` with the L2 made cold before each
    call by writing ``flush`` (larger than the 50 MB L2); the write is
    outside the timed interval."""
    fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(i & 0xFF)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def wide(t: torch.Tensor) -> torch.dtype:
    """The dtype a check computes ``t``'s error in: f64 for f64, else
    f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def hold(name: str, got: torch.Tensor, want: torch.Tensor,
         tol: float) -> float:
    """Finite output of the plain version's shape and dtype, within
    ``|got - want| <= tol + tol * |want|`` everywhere; returns the max
    abs error (in f64 for f64 tensors, else in f32)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    g, w = (t.to(wide(t)) for t in (got, want))
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff = (g - w).abs()
    err = float(diff.max())
    if not bool((diff <= tol + tol * w.abs()).all()):
        raise AssertionError(f"{name}: max abs err {err} outside the "
                             f"tolerance {tol} of the plain version")
    return err


def block_rel_rms(got: torch.Tensor, want: torch.Tensor,
                  rows: int = 64) -> float:
    """The largest ``||got - want||_2 / ||want||_2`` over the blocks of
    ``rows`` query rows of every (b, head) of a (B, H, S, d) output."""
    B, H, S, d = want.shape
    pad = -S % rows

    def blocks(x):
        return F.pad(x.float(), (0, 0, 0, pad)).reshape(B, H, -1, rows * d)

    num = blocks(got.float() - want.float()).norm(dim=-1)
    den = blocks(want).norm(dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def tile_drop_rms(q, k, v, causal, want, rows: int = 64,
                  tile: int = 64) -> float:
    """A control for the limit: the block_rel_rms that a kernel would
    read if it skipped, for the last ``rows`` query rows of (b 0, head 0),
    the kv tile of ``tile`` keys that carries most of their softmax mass
    (computed in f32, then rounded to the output's type)."""
    S, d = q.shape[2], q.shape[3]
    r0 = max(0, S - rows)
    s = q[0, 0, r0:].float() @ k[0, 0].float().T / math.sqrt(d)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[r0:, None], -1e30)
    mass = F.pad(torch.softmax(s, -1), (0, -S % tile)).reshape(
        S - r0, -1, tile).sum((0, 2))
    t = int(mass.argmax())
    s[:, t * tile:(t + 1) * tile] = -1e30
    ctrl = (torch.softmax(s, -1) @ v[0, 0].float()).to(want.dtype)
    return block_rel_rms(ctrl[None, None], want[:1, :1, r0:], rows)


def attention_cases(dev):
    """One layer's prefill at published widths: (name, q, k, v, causal)
    with inputs from numpy, seed 0.  qwen3-8b in bf16 (its dtype) and
    f32, qwen2-0.5b (7:1 GQA, d = 64), hubert-xlarge (full attention,
    d = 80), qwen3-8b in bf16 with q and k scaled by 8, so that the
    softmax is peaked and each output is O(1), and qwen2-0.5b and
    hubert-xlarge in f32, so that the CUDA-core kernel runs at the head
    dims of the configs; S = train_4k's sequence length, B = 1."""
    S = SHAPES["train_4k"].seq_len
    rng = np.random.default_rng(0)
    cases = []
    for arch, dtype, scale in (("qwen3-8b", torch.bfloat16, 1.0),
                               ("qwen3-8b", torch.float32, 1.0),
                               ("qwen2-0.5b", torch.bfloat16, 1.0),
                               ("hubert-xlarge", torch.bfloat16, 1.0),
                               ("qwen3-8b", torch.bfloat16, 8.0),
                               ("qwen2-0.5b", torch.float32, 1.0),
                               ("hubert-xlarge", torch.float32, 1.0)):
        cfg = get_arch(arch)
        d = cfg.head_dim
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, h, S, d)).astype(np.float32)).to(dev, dtype)
            for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        name = f"{arch}/{str(dtype)[6:]}" + ("/peaked" if scale != 1 else "")
        cases.append((name, q * scale, k * scale, v, cfg.causal))
    return cases


def large_v_probe(dev) -> dict:
    """q, k and v all scaled by 8 on inputs where rounding P to bf16
    before P.V misses the elementwise bf16 tolerance (S = 200, d = 96,
    8 / 2 heads, seed 200096): the kernel and SDPA's flash backend, which
    rounds P so, against the plain version; the kernel's block_rel_rms
    must stay in its limit and its max abs error within twice SDPA's,
    and since P.V adds P's bf16 high part and its residual, the kernel
    must hold the elementwise bf16 tolerance too."""
    rng = np.random.default_rng(200096)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, h, 200, 96)).astype(np.float32)).to(dev, torch.bfloat16) * 8
        for h in (8, 2, 2))
    tol = ATTN_TOL[torch.bfloat16]
    res = {}
    for causal in (True, False):
        want = attention_ref(q, k, v, causal=causal)
        with torch.nn.attention.sdpa_kernel(
                torch.nn.attention.SDPBackend.FLASH_ATTENTION):
            lib = F.scaled_dot_product_attention(
                q, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1),
                is_causal=causal)
        got = flash_attention(q, k, v, causal=causal)
        row = {}
        for who, out in (("kernel", got), ("sdpa_flash", lib)):
            diff = (out.float() - want.float()).abs()
            row[who] = {
                "max_abs_err": float(diff.max()),
                "elementwise_ok": bool(
                    (diff <= tol + tol * want.float().abs()).all()),
                "block_rel_rms": block_rel_rms(out, want)}
        if not (row["kernel"]["block_rel_rms"] <= ATTN_RMS_LIMIT[q.dtype]
                and row["kernel"]["max_abs_err"]
                <= 2 * row["sdpa_flash"]["max_abs_err"]
                and row["kernel"]["elementwise_ok"]):
            raise AssertionError(f"large v: {row}")
        res["causal" if causal else "full"] = row
    return res


def scan_cases(dev):
    """falcon-mamba-7b's selective scan, one layer, B = 1, S = 4096:
    Di = d_inner, N = d_state; x, dt, Bm, Cm in bf16 (the config's
    dtype) and in f32, A in f32; inputs from numpy, seed 1, as
    tests/test_kernels.py makes them."""
    cfg = get_arch("falcon-mamba-7b")
    S, Di, N = SHAPES["train_4k"].seq_len, cfg.d_inner, cfg.d_state
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, S, Di)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((1, S, Di)) - 2.0)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.3)
    Bm = rng.standard_normal((1, S, N)).astype(np.float32)
    Cm = rng.standard_normal((1, S, N)).astype(np.float32)
    A_t = torch.from_numpy(A.astype(np.float32)).to(dev)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        x_t, dt_t, B_t, C_t = (torch.from_numpy(
            a.astype(np.float32)).to(dev, dtype) for a in (x, dt, Bm, Cm))
        cases.append((f"falcon-mamba-7b/{str(dtype)[6:]}",
                      (x_t, dt_t, A_t, B_t, C_t)))
    return cases


def attention_flops(q, causal) -> int:
    B, Hq, S, d = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * Hq * pairs * d


def attention_bound(q, k, v, causal):
    moved = nbytes((q, k, v)) + q.numel() * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    return bound(moved, attention_flops(q, causal), rate)


def scan_bound(args, exp_per_s):
    x, _, A, _, _ = args
    B, S, Di = x.shape
    moved = nbytes(args) + x.numel() * x.element_size()
    return bound(moved, B * S * Di * A.shape[1], exp_per_s)


def decision_ops(slots: int, P: int, K: int, R: int, H: int) -> int:
    """f64 operations of ``slots`` decisions: per lane, per predecessor
    route hop a max, an add and a running max, per predecessor an arrival
    max, then EST max, EFT add, A/value/B multiplies; per slot the commit's
    add, divide, multiply and add."""
    return slots * (P * (K * (3 * R * H + 1) + 5) + 4)


def sched_kernel_times(wargs, wout, wb, pargs, pouts) -> dict:
    """Both scheduling kernels timed at exp7 in the real type of their
    tables: the wave kernel on one wave's staged inputs ``wargs`` (its
    outputs ``wout``, ``wb`` slots), the plan kernel on the 301-alpha
    plan ``pargs`` (its outputs ``pouts``).  ms: CUDA events around
    back-to-back wrapper calls (host-bound where the wrapper outlasts the
    kernel); device_ms: the device's time, the host's enqueue hidden;
    the plain version's ms; the bytes each must move (the float tables at
    their element size) and the bound against the peak of the type."""
    T = pargs["T"]
    P, R, H = T.P, T.R, T.H
    Kp = pargs["pred"].shape[2]
    W, B = pargs["task"].shape
    A = pargs["alphas"].shape[0]
    peak = FP64_OPS_PER_S if T.dtype == torch.float64 else FP32_OPS_PER_S
    k1_ms = event_ms(lambda: K.sched_wave(**wargs), 50)
    k1_device_ms = device_ms(lambda: K.sched_wave(**wargs), 50)
    k1_plain_ms = event_ms(lambda: K.wave_plain(**wargs), 3)
    k2_ms = event_ms(lambda: K.sched_plan(**pargs), 5)
    k2_device_ms = device_ms(lambda: K.sched_plan(**pargs), 5)
    k2_plain_ms = event_ms(lambda: K.plan_plain(**pargs), 1)
    ko, kst = wout
    k1_bytes = table_bytes(T, wargs["task"], wargs["pedge"], wargs["psrc"]) \
        + nbytes(tuple(wargs[k] for k in ("task", "real", "exitf", "paft",
                                          "psrc", "pedge"))
                 + wargs["state"] + ko.tensors() + kst)
    pv = pargs["pvalid"] > 0
    pred = pargs["pred"].long()
    k2_bytes = table_bytes(
        T, pargs["task"],
        torch.where(pv, pargs["pedge"], T.E).expand(A, *pv.shape),
        torch.where(pv, pouts[3][:, pred], P)) \
        + nbytes(tuple(pargs[k] for k in ("task", "real", "exitf", "pred",
                                          "pvalid", "pedge", "alphas", "aft0",
                                          "proc0")) + pargs["state"]
                 + pouts[0].tensors() + pouts[1] + pouts[2:])
    k1_bound, k1_by = bound(k1_bytes, decision_ops(wb, P, Kp, R, H), peak)
    k2_bound, k2_by = bound(k2_bytes, decision_ops(A * W * B, P, Kp, R, H),
                            peak)
    return {"dtype": str(T.dtype)[6:], "exp7_wave": {
        "B": wb, "ms": k1_ms, "device_ms": k1_device_ms,
        "us_per_decision": k1_ms * 1e3 / wb,
        "device_us_per_decision": k1_device_ms * 1e3 / wb,
        "plain_ms": k1_plain_ms, "bytes": k1_bytes, "bound_ms": k1_bound,
        "bound_by": k1_by}, "exp7_plan": {
        "A": A, "W": W, "B": B, "ms": k2_ms, "device_ms": k2_device_ms,
        "us_per_decision": k2_ms * 1e3 / (A * W * B),
        "us_per_decision_in_series": k2_ms * 1e3 / (W * B),
        "plain_ms": k2_plain_ms, "bytes": k2_bytes,
        "output_bytes": nbytes(pouts[0].tensors()), "bound_ms": k2_bound,
        "bound_by": k2_by}}


def check_waves(g, tg, q, alpha, period, timed_wave=None,
                dtype=torch.float64):
    """K1 on every wave of the plan: kernel vs plain on the same staged
    inputs, then the backend advances through the wave (in ``dtype``)."""
    inst = CompiledInstance(g, tg, rank=rank_matrix(g, tg), dtype=dtype)
    be = CudaBackend(inst, scan=False)
    be.start(alpha, period, True)
    preds = [list(g.pred[j]) for j in range(g.n)]
    waves = plan_waves(q, preds, DEFAULT_BATCH_MAX)
    err = 0.0
    timed = None
    for wv, js in enumerate(waves):
        args = be.stage_wave(js, True)
        ko, kst = K.sched_wave(**args)
        po, pst = K.wave_plain(**args)
        err = max(err, compare(f"sched_wave_kernel wave {wv}",
                               ko.tensors() + kst, po.tensors() + pst))
        if wv == timed_wave:
            timed = (args, ko, kst, len(js))
        be.evaluate_batch(js)
    return err, len(waves), timed


def check_plan(g, tg, q, alphas, period, dtype=torch.float64):
    """K2 on the whole plan under every alpha: kernel vs plain (in
    ``dtype``)."""
    inst = CompiledInstance(g, tg, rank=rank_matrix(g, tg), dtype=dtype)
    be = CudaBackend(inst)
    be.start(alphas[0], period, True)
    preds = [list(g.pred[j]) for j in range(g.n)]
    waves = plan_waves(q, preds, DEFAULT_BATCH_MAX)
    args = be.stage_plan(waves, alphas)
    ko, kst, kaft, kproc = K.sched_plan(**args)
    torch.cuda.synchronize()
    po, pst, paft, pproc = K.plan_plain(**args)
    err = compare("sched_plan_kernel", ko.tensors() + kst + (kaft, kproc),
                  po.tensors() + pst + (paft, pproc))
    return err, args, (ko, kst, kaft, kproc), len(waves)


def check_resumed(resumed, picks: int = 4) -> dict:
    """sched_plan_kernel on the staged inputs of resumed launches (one
    alpha, a suffix of waves, the state of the replayed prefix), held
    exactly to its plain version on the same card tensors: ``picks``
    launches evenly spaced over the path's resumed launches."""
    if not resumed:
        raise AssertionError("no sched_plan_kernel launch resumed from a "
                             "replayed prefix")
    idx = sorted({round(k * (len(resumed) - 1) / (picks - 1))
                  for k in range(picks)})
    err, rows = 0.0, []
    for k in idx:
        args = resumed[k]
        st = args["state"]
        if not bool((st[1] > 0).any()):
            raise AssertionError(f"resumed launch {k}: empty processor "
                                 f"state")
        ko, kst, kaft, kproc = K.sched_plan(**args)
        torch.cuda.synchronize()
        po, pst, paft, pproc = K.plan_plain(**args)
        err = max(err, compare(f"sched_plan_kernel resumed launch {k}",
                               ko.tensors() + kst + (kaft, kproc),
                               po.tensors() + pst + (paft, pproc)))
        rows.append({"launch": k, "waves": args["task"].shape[0],
                     "placed": int((args["proc0"] < args["T"].P).sum()),
                     "busy_links": int((st[0] > 0).sum())})
    return {"resumed_launches": len(resumed), "held": rows,
            "max_abs_err": err}


def recording_resumed(fn):
    """``fn()`` with the staged inputs of every sched_plan_kernel launch
    that starts from a replayed prefix (a placed task in proc0) kept, to
    hold the kernel against its plain version after the path: returns
    ``(fn(), resumed)``."""
    launch, resumed = K.sched_plan, []

    def recording(**args):
        if bool((args["proc0"] < args["T"].P).any()):
            resumed.append(args)
        return launch(**args)

    K.sched_plan = recording
    try:
        return fn(), resumed
    finally:
        K.sched_plan = launch


def same_plan(what, got, want) -> None:
    """A plan of the card held to a host session's (the port's scalar,
    vector or auto backend) bit for bit: every grid makespan, the best
    alpha, the best schedule's placements, start and finish times and
    message placements, the period."""
    ok = (got.period == want.period
          and (got.sweep is None) == (want.sweep is None)
          and all(np.array_equal(getattr(got.schedule, f),
                                 getattr(want.schedule, f))
                  for f in ("proc", "start", "finish"))
          and got.schedule.messages == want.schedule.messages
          and np.array_equal(got.graph.weights, want.graph.weights))
    if ok and got.sweep is not None:
        ok = (np.array_equal(got.sweep.alphas, want.sweep.alphas)
              and np.array_equal(got.sweep.makespans, want.sweep.makespans)
              and got.sweep.best_alpha == want.sweep.best_alpha)
    if not ok or got.fallback is not None or got.backend != "cuda":
        raise AssertionError(f"{what}: the card's plan differs from the "
                             f"{want.backend} session's")


def same_replay(what, got, want) -> dict:
    """``ReplayStats`` of the card held to the scalar session's.  A fresh
    grid (suffix 0) runs as the fused sweep, every alpha of it on the card
    where the host loop skips the alphas inside each trace's invariance
    interval: its two simulation counts are held to the fused sweep's own,
    every other field to the scalar session's."""
    a, b = dataclasses.asdict(got.replay), dataclasses.asdict(want.replay)
    if got.sweep is not None and len(got.sweep.alphas) > 1 \
            and got.replay.sims_resumed == 0:
        n_alpha = len(got.sweep.alphas)
        if (a.pop("sims_full"), a.pop("decisions_simulated")) != \
                (n_alpha, n_alpha * got.graph.n):
            raise AssertionError(f"{what}: fused sweep counts {got.replay}")
        del b["sims_full"], b["decisions_simulated"]
    if a != b:
        raise AssertionError(f"{what}: replay {got.replay} != {want.replay}")
    return dataclasses.asdict(got.replay)


def spec_faults(spec):
    """A fault spec as the fault records that start a session with it."""
    return [ProcessorDown(p) for p in spec.down_procs] + [
        LinkDown(link) if math.isinf(f) else LinkDegraded(link, f)
        for link, f in spec.link_factors]


def timed_calls(sched, calls):
    """Run ``(name, method, kwargs)`` calls on ``sched``: each plan, its
    wall seconds, its sched_plan_kernel launches and the device backend's
    last_timing."""
    out = []
    for name, method, kw in calls:
        n0 = K.LAUNCHES["sched_plan_kernel"]
        t0 = time.perf_counter()
        plan = getattr(sched, method)(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        inst = sched._last.inst if sched._last is not None else None
        be = inst._backends.get("cuda") if inst is not None else None
        timing = {} if isinstance(plan, int) or be is None \
            else dict(be.last_timing)
        out.append((name, plan, wall, K.LAUNCHES["sched_plan_kernel"] - n0,
                    timing))
    return out


def update_calls(g, q):
    """The update script at exp7: submit; probe_update and update for a
    task late in the queue, then for one at mid-queue; a batch of three
    events; one link-speed change."""
    late, mid = q[int(0.95 * len(q))], q[len(q) // 2]
    return [("submit", "submit", dict(g=g)),
            ("probe_late", "probe_update", dict(task_rates={late: 1.3})),
            ("update_late", "update", dict(task_rates={late: 1.3})),
            ("probe_mid", "probe_update", dict(task_rates={mid: 0.8})),
            ("update_mid", "update", dict(task_rates={mid: 0.8})),
            ("batch3", "update", dict(task_rates=[
                {q[-3]: 1.2}, {q[-40]: 0.9, q[-2]: 1.1}, {q[-7]: 1.05}])),
            ("link_speed", "update", dict(link_speed={"l3": 1.7}))]


def exp9_instance():
    """The exp9 deployment at its full size (benchmarks/exp9_faults.py,
    run(full=True)): 8 switched ECUs, one 240-task TGFF graph of seed
    9000."""
    tg = fully_switched_topology(8, EXP9_RATES, EXP9_10_SPEEDS)
    g = random_spg(240, np.random.default_rng(9000), ccr=1.0, tg=tg,
                   outdeg_constraint=True)
    return g, tg


def exp10_trace():
    """The exp10 request trace at its full size
    (benchmarks/exp10_service.py, _make_trace(full=True)): 8 tenants, each
    registering 4 graphs of 28 tasks, then 3 bursts of 3 drift updates."""
    tg = fully_switched_topology(8, EXP10_RATES, EXP9_10_SPEEDS)
    tenants = []
    for t in range(8):
        rng = np.random.default_rng(10_000 + t)
        graphs = [random_spg(28, rng, ccr=1.0, tg=tg, outdeg_constraint=True)
                  for _ in range(4)]
        for k, g in enumerate(graphs):
            g.name = f"t{t}g{k}"
        bursts = [[(f"t{t}g{int(rng.integers(4))}", int(rng.integers(28)),
                    float(rng.uniform(0.7, 1.4))) for _ in range(3)]
                  for _ in range(3)]
        tenants.append((f"tenant{t}", graphs, bursts))
    return tg, tenants


async def drive_service(svc, tenants):
    """exp10's request pattern: the registration bursts of all tenants
    at once, then each drift burst of all tenants at once; the final
    views."""
    clients = {name: svc.client(name) for name, _, _ in tenants}
    resps = await asyncio.gather(*[
        clients[name].register(g, name=g.name)
        for name, graphs, _ in tenants for g in graphs])
    for b in range(3):
        resps += await asyncio.gather(*[
            clients[name].update(task_rates={task: f}, graph=gname)
            for name, _, bursts in tenants for gname, task, f in bursts[b]])
    bad = [r for r in resps if not r.ok]
    if bad:
        raise AssertionError(f"service errors: {bad[:3]}")
    finals = {}
    for name, graphs, _ in tenants:
        for g in graphs:
            r = await clients[name].plan(graph=g.name)
            if not r.ok:
                raise AssertionError(f"service plan error: {r.error}")
            finals[(name, g.name)] = r.result
    return finals


def phase_update(drive, paths, g7, tg7, q7s) -> dict:
    """The replanning loop at exp7: submit, probe_update/update of a
    late and a mid-queue task, a batch of three events, a link-speed
    change; every plan held to the port's scalar session on the same
    calls.  A resumed update launches sched_plan_kernel once per
    re-simulated alpha, from the state of the replayed prefix."""
    calls = update_calls(g7, q7s)
    cu7 = Scheduler(tg7, policy=EXP7_POLICY)
    upd, resumed = recording_resumed(
        lambda: drive("exp7_update", lambda: timed_calls(cu7, calls)))
    resumed_err = check_resumed(resumed)
    t1 = time.perf_counter()
    upd_ref = timed_calls(Scheduler(tg7, policy=EXP7_POLICY,
                                    backend="scalar"), calls)
    upd_scalar_s = time.perf_counter() - t1
    upd_rows = {}
    for (name, got, wall, launches, timing), (_, want, swall, _, _) in zip(
            upd, upd_ref):
        row = {"wall_s": wall, "scalar_wall_s": swall,
               "sched_plan_kernel": launches}
        if isinstance(got, int):            # probe_update: the prefix
            assert got == want, (name, got, want)
            row["prefix"] = got
        else:
            same_plan(f"exp7 {name}", got, want)
            row.update(replay=same_replay(f"exp7 {name}", got, want),
                       makespan=got.makespan, best_alpha=got.best_alpha,
                       timing_s=timing)
        upd_rows[name] = row
    assert upd_rows["update_late"]["replay"]["suffix_start"] == \
        upd_rows["probe_late"]["prefix"] > 0
    assert upd_rows["batch3"]["replay"]["coalesced"] == 3
    assert upd_rows["link_speed"]["replay"]["suffix_start"] == 0
    return {"phase": "main_update", "P": tg7.n_procs, "n": g7.n,
            "alphas": len(upd[0][1].sweep.alphas), "calls": upd_rows,
            "scalar_session_s": upd_scalar_s,
            "resumed_vs_plain": resumed_err,
            "launches": paths["exp7_update"]}


def exp9_fault_calls(g9, tg9):
    """The exp9 fault script: submit, mark_failed of the processor that
    starts first, degrade of a link, mark_failed of the cold standby's
    link, degrade of a sink task, restore of the processor.  Returns the
    processor and the calls."""
    probe9 = Scheduler(tg9, policy=EXP9_POLICY, backend="scalar")
    p9 = probe9.submit(g9)
    hot = int(p9.schedule.proc[np.argmin(p9.schedule.start)])
    sink = [t for t in range(g9.n) if not g9.succ[t]][-1]
    # l8 is the cold standby's link: the only link of this graph whose
    # loss leaves every committed prefix feasible (the others partition
    # it, as benchmarks/exp9_faults.py finds link by link)
    return hot, [("submit", "submit", dict(g=g9)),
                 ("mark_failed_proc", "mark_failed", dict(proc=hot)),
                 ("degrade_link", "degrade", dict(link="l3", factor=2.0)),
                 ("mark_failed_link", "mark_failed", dict(link="l8")),
                 ("degrade_task", "degrade", dict(task=sink, factor=2.0)),
                 ("restore_proc", "restore", dict(proc=hot))]


def phase_faults(drive, paths, gp, tgp) -> dict:
    """Faults: the paper drill, then mark_failed / degrade / restore at
    the exp9 deployment, each plan held to the scalar session and to a
    fresh session started with the faults of that moment."""
    drill = Scheduler(tgp, policy=HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1))

    def drill_path():
        healthy = drill.submit(gp)
        return healthy, drill.mark_failed(proc=2)

    healthy, failed = drive("paper_faults", drill_path)
    assert (healthy.makespan, failed.makespan) == (65.0, 89.0), \
        (healthy.makespan, failed.makespan)
    assert schedule_violations(failed.schedule, drill.faults) == []
    assert failed.backend == "cuda" and failed.fallback is None
    g9, tg9 = exp9_instance()
    hot, fcalls = exp9_fault_calls(g9, tg9)
    cu9 = Scheduler(tg9, policy=EXP9_POLICY)
    sc9 = Scheduler(tg9, policy=EXP9_POLICY, backend="scalar")
    fault_rows = {}

    def fault_path():
        out = []
        for call in fcalls:
            (res,) = timed_calls(cu9, [call])
            (ref_res,) = timed_calls(sc9, [call])
            out.append((res, ref_res, cu9.faults))
        return out

    for (name, got, wall, launches, timing), (_, want, swall, _, _), spec \
            in drive("exp9_faults", fault_path):
        same_plan(f"exp9 {name}", got, want)
        fresh = Scheduler(tg9, policy=dataclasses.replace(
            EXP9_POLICY, period=got.period), faults=spec_faults(spec)
        ).submit(got.graph)
        same_plan(f"exp9 {name} against a fresh session", got, fresh)
        assert schedule_violations(got.schedule, spec) == []
        fault_rows[name] = {
            "wall_s": wall, "scalar_wall_s": swall,
            "sched_plan_kernel": launches, "makespan": got.makespan,
            "invalidated_by_fault": got.replay.invalidated_by_fault,
            "replay": same_replay(f"exp9 {name}", got, want),
            "faults": spec.describe(), "timing_s": timing}
    return {"phase": "main_faults", "paper_drill": {
                "healthy": healthy.makespan, "proc2_down": failed.makespan,
                "invalidated_by_fault": failed.replay.invalidated_by_fault},
            "exp9": {"P": tg9.n_procs, "n": g9.n, "hot_proc": hot,
                     "calls": fault_rows},
            "launches": {k: paths[k]
                         for k in ("paper_faults", "exp9_faults")}}


def phase_backends(drive, paths, gp, tgp) -> dict:
    """The backend names a reference user passes: ``auto`` and ``vector``
    sessions beside a ``cuda`` one on the same calls.  The paper example
    (P 3: ``auto`` resolves to scalar) submits under each policy; the
    exp9 deployment (8 ECUs, link-disjoint routes: ``auto`` resolves to
    vector) runs its fault script.  Every host plan is held bit for bit
    to the cuda plan of the same call (ReplayStats too, bar the fused
    sweep's counts); the host backends launch no kernel.  Wall seconds
    of each backend's calls."""
    t_phase = time.perf_counter()
    policies = (HSV_CC(), HVLB_CC_B(**PAPER_POLICY),
                HVLB_CC_IC(**PAPER_POLICY))
    g9, tg9 = exp9_instance()
    _, fcalls = exp9_fault_calls(g9, tg9)
    runs = {}
    for b in BACKEND_NAMES:
        sp = Scheduler(tgp, backend=b)
        t0 = time.perf_counter()
        paper = drive(f"backend_{b}_paper",
                      lambda: [sp.submit(gp, pol) for pol in policies])
        paper_s = time.perf_counter() - t0
        s9 = Scheduler(tg9, policy=EXP9_POLICY, backend=b)
        t0 = time.perf_counter()
        exp9 = drive(f"backend_{b}_exp9", lambda: timed_calls(s9, fcalls))
        runs[b] = (paper, paper_s, exp9, time.perf_counter() - t0)
    cuda_paper, _, cuda_exp9, _ = runs["cuda"]
    out = {}
    for b, (paper, paper_s, exp9, exp9_s) in runs.items():
        resolved = {"paper": sorted({p.backend for p in paper}),
                    "exp9": sorted({r[1].backend for r in exp9})}
        want = {"cuda": ("cuda", "cuda"), "vector": ("vector", "vector"),
                "auto": ("scalar", "vector")}[b]
        assert (resolved["paper"], resolved["exp9"]) == \
            ([want[0]], [want[1]]), (b, resolved)
        row = {"resolved": {"paper": want[0], "exp9": want[1]},
               "paper_s": paper_s, "exp9_s": exp9_s,
               "exp9_calls_s": {r[0]: r[2] for r in exp9},
               "launches": {k: paths[f"backend_{b}_{k}"]
                            for k in ("paper", "exp9")}}
        if b != "cuda":
            for pol, got, want_p in zip(policies, cuda_paper, paper):
                same_plan(f"paper {type(pol).__name__} {b}", got, want_p)
            for (name, got, *_), (_, want_p, *_) in zip(cuda_exp9, exp9):
                same_plan(f"exp9 {name} {b}", got, want_p)
                same_replay(f"exp9 {name} {b}", got, want_p)
            assert all(n == 0 for k in ("paper", "exp9")
                       for n in paths[f"backend_{b}_{k}"].values()), row
        out[b] = row
    return {"phase": "backend_auto", "P": {"paper": tgp.n_procs,
                                           "exp9": tg9.n_procs},
            "n": {"paper": gp.n, "exp9": g9.n},
            "policies": [type(p).__name__ for p in policies],
            "exp9_calls": [c[0] for c in fcalls], "backends": out,
            "bit_identical_to_cuda": True,
            "phase_s": time.perf_counter() - t_phase}


def first_divergence(slots, out32, out64, alpha: float):
    """Where the float32 plan of one alpha parts from the float64 plan
    (decisions: the winner of each real slot and its routes), and the
    gap there: the relative gap of the two winners' float64 selection
    values (Def. 4.2, ``A + B * alpha``, ``A`` for an exit task), or of
    the two routes' final LFTs when only a route differs.  ``slots``:
    the plan's real, exit and predecessor-count arrays (W, B);
    ``out32`` / ``out64``: the plan kernels' outputs of this alpha, on
    the host.  None where the two agree."""
    real, exitf, npred = slots
    win32, win64 = out32["win"], out64["win"]
    W, B = real.shape
    for wv in range(W):
        for b in range(B):
            if not real[wv, b]:
                continue
            k = int(npred[wv, b])
            p32, p64 = int(win32[wv, b]), int(win64[wv, b])
            r32, r64 = out32["route"][wv, b, :k], out64["route"][wv, b, :k]
            if p32 == p64 and np.array_equal(r32, r64):
                continue
            if p32 != p64:
                ca, cb = out64["ca"][wv, b], out64["cb"][wv, b]
                val = (lambda p: ca[p]) if exitf[wv, b] \
                    else (lambda p: ca[p] + cb[p] * alpha)
                v32, v64 = val(p32), val(p64)
                return {"wave": wv, "slot": b, "kind": "processor",
                        "f64_values": [v64, v32],
                        "rel_gap": abs(v32 - v64) / abs(v64)}
            kk = int(np.flatnonzero(r32 != r64)[0])
            f32_, f64_ = (float(o["lft"][wv, b, kk, -1])
                          for o in (out32, out64))
            return {"wave": wv, "slot": b, "kind": "route", "pred": kk,
                    "lfts": [f64_, f32_],
                    "rel_gap": abs(f32_ - f64_) / abs(f64_)}
    return None


def plan_on_host(pouts) -> dict:
    """The decisions of a plan kernel's outputs (every alpha), on the
    host, floats in float64."""
    out = pouts[0]
    return {k: getattr(out, k).cpu().numpy().astype(
        np.float64 if getattr(out, k).dtype.is_floating_point else np.int64)
        for k in ("win", "ca", "cb", "lft", "route")}


def run_examples(device: str = "cuda") -> dict:
    """Each example of the port on ``device`` (the card), at its default
    size, in a process of its own; the three run side by side.  Its wall
    seconds, exit code and last line; any failure raises, after every
    process has ended."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    shutil.rmtree(ROOT / "build" / "example_ckpt", ignore_errors=True)
    procs = {}
    try:
        for name, argv in EXAMPLES:
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}",
                 "--device", device, *argv], cwd=ROOT, env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        rows = {}
        for name, (t0, proc) in procs.items():
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            lines = out.strip().splitlines()
            rows[name] = {"wall_s": time.perf_counter() - t0,
                          "rc": proc.returncode,
                          "last_line": lines[-1] if lines else "",
                          "lines": len(lines)}
            if proc.returncode != 0:
                raise AssertionError(f"example {name} failed "
                                     f"({proc.returncode}): {err[-2000:]}")
            rows[name]["out"] = lines
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ROOT / "build" / "example_ckpt", ignore_errors=True)
    qs = rows["quickstart"].pop("out")
    assert qs[0].startswith("HSV_CC   makespan= 73.0"), qs[0]
    assert f"cuda on {device} (float32, 301 alphas in one dispatch): " \
        f"makespan=62.0 at alpha=1.06" in qs, qs
    ds = rows["dsms_serve"].pop("out")
    assert "done." in ds and ds[-1] == "service quickstart done.", ds[-4:]
    tr = rows["train_lm"].pop("out")
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in tr
              if "loss=" in ln]
    assert tr[-1] == "done." and losses and all(
        math.isfinite(x) for x in losses), tr[-4:]
    rows["train_lm"]["losses_printed"] = losses
    return rows


def phase_f32(drive, paths, ctx) -> dict:
    """The device backend's float32 mode (``dtype=torch.float32``, the
    reference's TPU numerics, its near-tie policy).  Both kernels against
    their plain versions in float32, bit for bit, at the paper instance
    (waves at alpha 1.06, the 301-alpha plan) and at exp7 (waves and
    the 301-alpha plan); both timed at exp7.  The paper's three submits
    and its fault drill in float32, placements equal to float64's; the
    exp7 submit beside float64, and how many of its 301 alphas decide as
    in float64, each that parts doing so at a near-tie (a gap under
    F32_NEAR_TIE_RTOL between the two float64 values that decided); the
    exp9 fault script in float32 without violations."""
    t_phase = time.perf_counter()
    gp, tgp, qp, grid = ctx["gp"], ctx["tgp"], ctx["qp"], ctx["grid"]
    g7, tg7, q7, period7 = ctx["g7"], ctx["tg7"], ctx["q7"], ctx["period7"]
    # ---- the kernels against their plain versions
    e_w_paper, _, _ = check_waves(gp, tgp, qp, 1.06, 150.0, dtype=F32)
    e_p_paper, _, _, _ = check_plan(gp, tgp, qp, grid, 150.0, dtype=F32)
    e_w7, _, (wargs, ko, kst, wb) = check_waves(
        g7, tg7, q7, 1.0, period7, timed_wave=16, dtype=F32)
    e_p7, pargs, pouts, _ = check_plan(g7, tg7, q7, grid, period7, dtype=F32)
    assert pouts[0].ca.dtype == F32 and wargs["paft"].dtype == F32
    times = sched_kernel_times(wargs, (ko, kst), wb, pargs, pouts)
    # ---- the paper: three submits and the fault drill
    sched = Scheduler(tgp, dtype=F32)
    hsv, hv, ic = drive("f32_paper_submit", lambda: (
        sched.submit(gp, HSV_CC()),
        sched.submit(gp, HVLB_CC_B(**PAPER_POLICY)),
        sched.submit(gp, HVLB_CC_IC(**PAPER_POLICY))))
    paper = {}
    for name, got, want in (("HSV_CC", hsv, ctx["hsv"]),
                            ("HVLB_CC_B", hv, ctx["hv"]),
                            ("HVLB_CC_IC", ic, ctx["ic"])):
        assert got.backend == "cuda" and got.fallback is None
        assert np.array_equal(got.schedule.proc, want.schedule.proc), name
        assert schedule_violations(got.schedule) == [], name
        paper[name] = {"makespan": got.makespan,
                       "f64_makespan": want.makespan,
                       "best_alpha": got.best_alpha,
                       "f64_best_alpha": want.best_alpha}
    holes = {f"n{t + 1}": h for t, h in ic.holes.items() if np.isfinite(h)}
    assert holes == {"n1": 1.0, "n6": 4.0}, ic.holes
    paper["HVLB_CC_IC"]["holes"] = holes
    inst_p = CompiledInstance(gp, tgp, rank=rank_matrix(gp, tgp), dtype=F32)
    wave_s = drive("f32_paper_per_wave", lambda: inst_p.schedule(
        qp, 1.06, period=150.0, backend=CudaBackend(inst_p, scan=False)))
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(wave_s, f), getattr(hv.schedule, f))
    drill_pol = HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1)
    d64 = Scheduler(tgp, policy=drill_pol)
    d64.submit(gp)
    f64_failed = d64.mark_failed(proc=2)
    drill = Scheduler(tgp, policy=drill_pol, dtype=F32)
    healthy, failed = drive("f32_paper_faults", lambda: (
        drill.submit(gp), drill.mark_failed(proc=2)))
    assert (healthy.makespan, failed.makespan) == (65.0, 89.0), \
        (healthy.makespan, failed.makespan)
    assert schedule_violations(failed.schedule, drill.faults) == []
    assert np.array_equal(failed.schedule.proc, f64_failed.schedule.proc)
    # ---- exp7: the submit beside float64's, then every alpha's decisions
    sched7 = Scheduler(tg7, dtype=F32)
    t0 = time.perf_counter()
    plan7 = drive("f32_exp7_submit", lambda: sched7.submit(g7, EXP7_POLICY))
    submit_s = time.perf_counter() - t0
    be7 = sched7._sessions[id(g7)].inst.backend_instance("cuda")
    assert be7.dtype == F32 and plan7.backend == "cuda"
    # a float32 plan's durations hold to float32 rounding: checked at its
    # slack, FLOAT32_RTOL; every other invariant holds exactly
    assert schedule_violations(plan7.schedule, rtol=FLOAT32_RTOL) == []
    inst7 = CompiledInstance(g7, tg7, rank=rank_matrix(g7, tg7), dtype=F32)
    q7s = sched7._sessions[id(g7)].queue_for(tg7, EXP7_POLICY)
    wave7 = drive("f32_exp7_per_wave", lambda: inst7.schedule(
        q7s, plan7.best_alpha, period=plan7.period,
        backend=CudaBackend(inst7, scan=False)))
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(wave7, f), getattr(plan7.schedule, f))
    slots = (pargs["real"].cpu().numpy() > 0,
             pargs["exitf"].cpu().numpy() > 0,
             pargs["pvalid"].cpu().numpy().sum(-1))
    h32, h64 = plan_on_host(pouts), plan_on_host(ctx["pouts64"])
    identical, parted = 0, []
    for a, alpha in enumerate(grid):
        d = first_divergence(slots, {k: v[a] for k, v in h32.items()},
                             {k: v[a] for k, v in h64.items()}, alpha)
        if d is None:
            identical += 1
            continue
        d["alpha"] = alpha
        parted.append(d)
        if not d["rel_gap"] < K.F32_NEAR_TIE_RTOL:
            raise AssertionError(f"exp7 float32 plan parts from float64 "
                                 f"beyond the near-tie band: {d}")
    f64_7 = ctx["plan7"]
    exp7 = {"P": tg7.n_procs, "n": g7.n, "alphas": len(grid),
            "submit_s": submit_s, "f64_submit_s": ctx["submit7_s"],
            "timing_s": dict(be7.last_timing),
            "f64_timing_s": ctx["timing7"],
            "plan_kernel_device_ms": times["exp7_plan"]["device_ms"],
            "makespan": plan7.makespan, "f64_makespan": f64_7.makespan,
            "best_alpha": plan7.best_alpha,
            "f64_best_alpha": f64_7.best_alpha,
            "alphas_decision_identical": identical,
            "alphas_parted": len(parted),
            "max_rel_gap_where_parted": max(
                (d["rel_gap"] for d in parted), default=None),
            "parted": parted[:20], "near_tie_rtol": K.F32_NEAR_TIE_RTOL}
    # ---- exp9: the fault script in float32
    g9, tg9 = exp9_instance()
    _, fcalls = exp9_fault_calls(g9, tg9)
    s9 = Scheduler(tg9, policy=EXP9_POLICY, dtype=F32)
    t0 = time.perf_counter()

    def fault_path():
        out = []
        for call in fcalls:
            (res,) = timed_calls(s9, [call])
            out.append((res, s9.faults))
        return out

    rows9 = {}
    for (name, got, wall, launches, timing), spec in drive(
            "f32_exp9_faults", fault_path):
        assert got.backend == "cuda" and got.fallback is None
        assert schedule_violations(got.schedule, spec,
                                   rtol=FLOAT32_RTOL) == [], name
        rows9[name] = {"wall_s": wall, "makespan": got.makespan,
                       "f64_makespan":
                           ctx["exp9"]["calls"][name]["makespan"],
                       "sched_plan_kernel": launches,
                       "invalidated_by_fault":
                           got.replay.invalidated_by_fault}
    exp9_s = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    # ---- the examples, on the card
    examples = run_examples(ctx.get("device", "cuda"))
    return {"phase": "f32_mode", "dtype": "float32",
            "near_tie_rtol": K.F32_NEAR_TIE_RTOL,
            "kernels_vs_plain": {
                "exact": True,
                "paper": {"wave_max_abs_err": e_w_paper,
                          "plan_max_abs_err": e_p_paper},
                "exp7": {"wave_max_abs_err": e_w7,
                         "plan_max_abs_err": e_p7}},
            "kernel_times": times,
            "paper": paper, "paper_drill": {
                "healthy": healthy.makespan, "proc2_down": failed.makespan,
                "invalidated_by_fault": failed.replay.invalidated_by_fault},
            "exp7": exp7, "exp9": {"calls": rows9, "script_s": exp9_s},
            "phase_s": phase_s, "examples": examples,
            "launches": {k: paths[k] for k in F32_PATHS}}


# the paths of phase f32_mode: each launches the float32 kernels only
F32_PLAN_PATHS = ("f32_paper_submit", "f32_paper_faults", "f32_exp7_submit",
                  "f32_exp9_faults")
F32_WAVE_PATHS = ("f32_paper_per_wave", "f32_exp7_per_wave")
F32_PATHS = F32_PLAN_PATHS + F32_WAVE_PATHS


def phase_service(drive, paths) -> dict:
    """The scheduler service on the card: the exp10 trace with coalescing
    on and off; every tenant's final fleet held to a scalar submit_many on
    the final state."""
    tg10, tenants = exp10_trace()
    svc_runs = {}
    for coalesce in (True, False):
        svc = SchedulerService(tg10, EXP9_POLICY, workers=4,
                               coalesce=coalesce)
        t1 = time.perf_counter()
        finals = drive(f"service_{'on' if coalesce else 'off'}",
                       lambda: asyncio.run(drive_service(svc, tenants)))
        wall = time.perf_counter() - t1
        svc.close()
        svc_runs[coalesce] = (svc, finals, wall)
    (svc_on, fin_on, wall_on), (svc_off, fin_off, _) = \
        svc_runs[True], svc_runs[False]
    assert fin_on == fin_off, "coalesced and uncoalesced views differ"
    for name, graphs, _ in tenants:
        for svc in (svc_on, svc_off):
            t = svc._tenants[name]
            view = fin_on[(name, graphs[0].name)]
            want = Scheduler(t.topology, backend="scalar",
                             policy=dataclasses.replace(
                                 EXP9_POLICY, period=view["period"]),
                             faults=t.fault_records).submit_many(
                list(t.graphs.values()))
            assert t.fleet.backend == "cuda" and t.fleet.fallback is None
            for f in ("proc", "start", "finish"):
                assert np.array_equal(getattr(t.fleet.schedule, f),
                                      getattr(want.schedule, f)), (name, f)
            assert t.fleet.schedule.messages == want.schedule.messages
    st_on, st_off = svc_on.stats, svc_off.stats
    return {"phase": "main_service", "tenants": len(tenants),
            "graphs_per_tenant": 4, "n": 28, "P": tg10.n_procs,
            "requests": st_on.requests, "wall_s": wall_on,
            "requests_per_s": st_on.requests / wall_on,
            "mean_replan_latency_s": st_on.mean_replan_latency_s(),
            "p99_replan_latency_s": st_on.p99_replan_latency_s(),
            "replans_coalesced": st_on.replans,
            "replans_uncoalesced": st_off.replans,
            "uncoalesced": {
                "wall_s": svc_runs[False][2],
                "mean_replan_latency_s": st_off.mean_replan_latency_s(),
                "p99_replan_latency_s": st_off.p99_replan_latency_s()},
            "launches": {k: paths[k]
                         for k in ("service_on", "service_off")}}


def busy_us(events) -> float:
    """Length of the union of ``[ts, ts + dur)`` over ``events``."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def device_trace(fn, n):
    """``fn()``, which runs ``n`` steps, under torch.profiler: the
    device's busy time a step (the union of its kernel, memcpy and memset
    intervals, ms), the kernels a step, and the five kernels (by name)
    that take the most device time, in ms a step.  The trace goes to the
    checkout's build/ and is removed once read."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "device_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    finally:
        path.unlink()
    if not events:
        raise AssertionError("the trace holds no device activity")
    kernels, by_name = 0, {}
    for e in events:
        if e["cat"] == "kernel":
            kernels += 1
            by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) \
                + e["dur"]
    top = {k: v / 1e3 / n for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:5]}
    return busy_us(events) / 1e3 / n, kernels / n, top


def profiled_steps(eng, toks, n):
    """``n`` decode steps under torch.profiler (``device_trace``)."""
    def steps():
        nonlocal toks
        for _ in range(n):
            toks = eng.step(toks).tokens
    return device_trace(steps, n)


def decode_and_forward(cfg, params, toks):
    """The logits over ``toks`` (B, S) from S ``decode_step`` calls and
    from one ``forward``, on the tensors' device."""
    dev = toks.device
    B, S = toks.shape
    full = M.forward(cfg, params, {"tokens": toks})
    cache = M.init_cache(cfg, B, S, dev)
    dec = torch.stack([M.decode_step(
        cfg, params, cache, toks[:, t:t + 1],
        torch.full((B,), t, device=dev))[0][:, 0] for t in range(S)], 1)
    return dec, full


def cut_params(cfg, seed):
    """f32 master weights of ``cfg`` on the card, from ``seed``."""
    dev = torch.device("cuda")
    return init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                       dev)


def decode_tokens(cfg, S=16):
    return torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (SERVE_BATCH, S))).to("cuda")


def decode_vs_forward(arch, n_layers, dtype) -> dict:
    """``arch`` at full width, cut to ``n_layers``: the logits of 16
    ``decode_step`` calls against ``forward`` over the same 16 tokens,
    held elementwise at ``DECODE_TOL``."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype=str(dtype).replace("torch.", ""))
    params = M._cast(cut_params(cfg, 1), dtype)
    toks = decode_tokens(cfg)
    dec, full = decode_and_forward(cfg, params, toks)
    tol = DECODE_TOL[dtype]
    err = hold(f"{arch} decode_step vs forward {cfg.dtype}", dec, full, tol)
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "tokens": toks.shape[1], "max_abs_err": err,
            "max_abs_logit": full.abs().max().item(), "tol": tol}


def hybrid_block_updates(arch, n_layers, attn_every, dtype):
    """The hybrid at full width, cut to ``n_layers`` in groups of
    ``attn_every``, in ``dtype`` (TF32 off), block by block: for each
    Mamba-2 layer and each group's shared block, its name and its update
    (its output less its input) from 16 decode steps from an empty state
    on the forward's own input to that block, and from the forward's
    block."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              attn_every=attn_every, dtype="float32")
    params = M._cast(cut_params(cfg, 1), dtype)
    cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    toks = decode_tokens(cfg)
    (B, S), dev = toks.shape, toks.device
    x = M._embed_tokens(cfg, params, {"tokens": toks})
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = M.init_cache(cfg, B, S, dev)
    out = []

    def steps(fn):
        return torch.cat([fn(t) for t in range(S)], dim=1)

    for g, group in enumerate(M._groups(cfg, params["blocks"])):
        for j, p in enumerate(group):
            want = M._mamba2_block(cfg, p, x)
            got = steps(lambda t: M._ssm_decode(
                cfg, L.mamba2, p, x[:, t:t + 1], cache["ssm_h"][g, j],
                cache["ssm_conv"][g, j]))
            out.append((f"group {g} layer {j}", got - x, want - x))
            x = want
        want = M._dense_block(cfg, params["shared"], x, positions)
        got = steps(lambda t: M._dense_block(
            cfg, params["shared"], x[:, t:t + 1], positions[:, t:t + 1],
            cache={"k": cache["k"][g], "v": cache["v"][g]},
            cache_pos=torch.full((B,), t, device=dev)))
        out.append((f"group {g} shared block", got - x, want - x))
        x = want
    return out


def hybrid_blocks_decode_vs_forward(arch, n_layers, attn_every) -> dict:
    """``hybrid_block_updates`` in f32, each block's decode update held
    against its forward update at ``DECODE_TOL`` of the update's scale
    (its largest magnitude, at least 1): an f32 sum's rounding scales
    with its terms, and the shared attention's output reaches ~40 at the
    reference's init.  An addition to the whole model's check
    (``hybrid_decode_vs_forward``): it names the block where a decode
    parts from its forward."""
    tol, err, scales = DECODE_TOL[torch.float32], 0.0, []
    for name, got, want in hybrid_block_updates(arch, n_layers, attn_every,
                                                torch.float32):
        scale = max(1.0, float(want.abs().max()))
        scales.append(scale)
        err = max(err, hold(f"{arch} {name} decode vs forward", got / scale,
                            want / scale, tol) * scale)
    return {"blocks": len(scales), "max_abs_err": err, "tol": tol,
            "update_scales": scales}


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.to(wide(got)), want.to(wide(want))
    return float((g - w).norm() / w.norm())


DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def gap_readings(cfg, masters, toks) -> dict:
    """``decode_and_forward`` of ``cfg`` on its f32 ``masters`` in f64,
    f32 and bf16: per dtype the relative RMS ``gap`` of decode against
    forward, its max abs, and the forward's own ``error``, against the
    next wider dtype's forward (f32 against f64, bf16 against f32).
    Returns the readings and the f64 decode and forward logits."""
    out, fulls = {}, {}
    for name, dt in DTYPES.items():
        c = dataclasses.replace(cfg, dtype=name)
        dec, full = decode_and_forward(c, M._cast(masters, dt), toks)
        if not bool(torch.isfinite(dec).all() & torch.isfinite(full).all()):
            raise AssertionError(f"{cfg.name} {name}: non-finite logits")
        fulls[name] = full
        if name == "float64":
            exact = dec, full
        d = (dec - full).abs()
        out[name] = {"gap": rel_rms(dec, full), "max_abs_err": float(d.max()),
                     "outside_1e-4": float(
                         (d > 1e-4 + 1e-4 * full.abs()).double().mean()),
                     "max_abs_logit": float(full.abs().max())}
    out["float32"]["error"] = rel_rms(fulls["float32"], fulls["float64"])
    out["bfloat16"]["error"] = rel_rms(fulls["bfloat16"], fulls["float32"])
    return out, exact


def hybrid_decode_readings(arch, n_layers, attn_every) -> dict:
    """``gap_readings`` of the hybrid at full width, cut to ``n_layers``
    in groups of ``attn_every``, on the card (TF32 off)."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              attn_every=attn_every, dtype="float32")
    return gap_readings(cfg, cut_params(cfg, 1), decode_tokens(cfg))


def hybrid_decode_vs_forward(arch, n_layers, attn_every) -> dict:
    """The whole hybrid's ``decode_step`` against its ``forward``
    (``hybrid_decode_readings``): f64 elementwise at ``F64_TOL``; f32 by
    relative RMS within ``F32_GAP_RATIO`` times the f32 forward's error;
    bf16 within ``HYBRID_BF16_GAP_RATIO`` times the bf16 forward's
    error.  Then the f32 block-by-block check as well."""
    r, (dec, full) = hybrid_decode_readings(arch, n_layers, attn_every)
    hold(f"{arch} decode_step vs forward float64", dec, full, F64_TOL)
    r["float64"]["tol"] = F64_TOL
    for name, ratio in (("float32", F32_GAP_RATIO),
                        ("bfloat16", HYBRID_BF16_GAP_RATIO)):
        got = r[name]
        got["limit"] = ratio * got["error"]
        if not got["gap"] <= got["limit"]:
            raise AssertionError(
                f"{arch} {name} decode_step vs forward: relative RMS "
                f"{got['gap']} above {got['limit']} ({ratio} x the "
                f"forward's {name} error {got['error']})")
    r["float32"]["blocks"] = hybrid_blocks_decode_vs_forward(
        arch, n_layers, attn_every)
    return {"n_layers": n_layers, "attn_every": attn_every,
            "d_model": get_arch(arch).d_model, **r}


def routed(fn, picks=None):
    """``fn()`` with the picks of every MoE call of the model kept
    (``moe_route``'s, on the host): ``(fn(), picks kept)``.  Given
    ``picks`` (a list in call order, as kept by an earlier run of the
    same calls), call i routes to ``picks[i]`` instead (the model's own
    ``_dispatch`` of them), and what is kept is each call's own picks."""
    orig, kept = L.moe_route, []

    def route(cfg, p, x):
        idx, disp, comb = orig(cfg, p, x)
        kept.append(idx.cpu())
        if picks is None:
            return idx, disp, comb
        forced = picks[len(kept) - 1].to(idx.device)
        probs, C = L._router_probs(cfg, p, x)
        return (forced, *L._dispatch(probs.gather(-1, forced), forced,
                                     cfg.n_experts, C))

    L.moe_route = route
    try:
        return fn(), kept
    finally:
        L.moe_route = orig


def moe_card_vs_cpu(arch, n_layers) -> dict:
    """The MoE model at full width, cut to ``n_layers``: 16
    ``decode_step`` calls and one ``forward`` on the card against the
    same port functions on the CPU on the same f32 masters, in f64 and
    in f32 (TF32 off), every MoE call's picked experts equal (card and
    CPU, f32 and f64).  f64 is held elementwise at ``F64_TOL``; f32 by
    relative RMS within ``F32_GAP_RATIO`` times the CPU's f32 error
    (its f32 logits against its f64 ones).  (Decode differs from forward
    by the reference's design: a step's group is the batch, so its
    capacity is 1; the gap is reported.)"""
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    masters = cut_params(cfg, 1)
    host = tree_map(lambda a: a.cpu(), masters)
    toks = decode_tokens(cfg)
    runs, routes = {}, []
    for name in ("float64", "float32"):
        c = dataclasses.replace(cfg, dtype=name)
        for where, p, t in (("card", masters, toks),
                            ("cpu", host, toks.cpu())):
            p = M._cast(p, DTYPES[name])
            got, r = routed(lambda: decode_and_forward(c, p, t))
            runs[name, where] = [a.cpu() for a in got]
            routes.append(r)
            del p
    if not all(len(r) == len(routes[0]) and all(
            torch.equal(a, b) for a, b in zip(r, routes[0]))
            for r in routes):
        raise AssertionError(f"{arch}: the card and the CPU, or f32 and "
                             f"f64, routed tokens to other experts")
    del masters
    out = {"n_layers": n_layers, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.top_k,
           "tokens": toks.shape[1], "moe_calls": len(routes[0]),
           "routes_equal": True}
    for i, what in enumerate(("decode", "forward")):
        card, cpu = runs["float64", "card"][i], runs["float64", "cpu"][i]
        r64 = {"max_abs_err": hold(f"{arch} {what} card vs cpu float64",
                                   card, cpu, F64_TOL), "tol": F64_TOL}
        card, cpu = runs["float32", "card"][i], runs["float32", "cpu"][i]
        error = rel_rms(cpu, runs["float64", "cpu"][i])
        r32 = {"rel_rms": rel_rms(card, cpu), "error": error,
               "limit": F32_GAP_RATIO * error,
               "max_abs_err": float((card - cpu).abs().max())}
        if not (bool(torch.isfinite(card).all())
                and r32["rel_rms"] <= r32["limit"]):
            raise AssertionError(f"{arch} {what} card vs cpu float32: "
                                 f"{r32}")
        out[what] = {"float64": r64, "float32": r32}
    dec, full = runs["float32", "card"]
    out["decode_vs_forward_max_abs"] = float((dec - full).abs().max())
    out["max_abs_logit"] = float(full.abs().max())
    return out


def moe_layer_card_vs_cpu(arch) -> dict:
    """One MoE layer of ``arch`` at full width in f32 (TF32 off), random
    weights by the init rule (N(0, 1) / sqrt(fan_in)): on the card
    against the CPU on a decode-sized group (the batch, capacity 1) and
    a prefill-sized one (batch x 16 tokens), the output within
    ``DECODE_TOL`` and the picks and dispatch mask equal."""
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {"w_router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F),
              "w_down": (E, F, D)}
    p = {k: torch.randn(s, generator=gen, device="cuda").mul_(
        1.0 / math.sqrt(s[-2])) for k, s in shapes.items()}
    host = {k: v.cpu() for k, v in p.items()}
    weight_bytes = nbytes(p.values())
    tol = DECODE_TOL[torch.float32]
    out = {"d_model": D, "d_ff": F, "experts": E, "top_k": cfg.top_k,
           "weight_bytes": weight_bytes}
    for name, S in (("decode", 1), ("prefill", 16)):
        x = torch.randn((SERVE_BATCH, S, D), generator=gen, device="cuda")
        idx, disp, _ = L.moe_route(cfg, p, x)
        cidx, cdisp, _ = L.moe_route(cfg, host, x.cpu())
        if not (torch.equal(idx.cpu(), cidx)
                and torch.equal(disp.cpu(), cdisp)):
            raise AssertionError(f"{arch} moe {name}: the card routed "
                                 f"otherwise than the CPU")
        t0 = time.perf_counter()
        cpu_out = L.moe(cfg, host, x.cpu())
        cpu_s = time.perf_counter() - t0
        err = hold(f"{arch} moe {name} card vs cpu", L.moe(cfg, p, x).cpu(),
                   cpu_out, tol)
        out[name] = {"tokens": SERVE_BATCH * S, "capacity": disp.shape[-1],
                     "kept_picks": int(disp.sum()),
                     "picks": SERVE_BATCH * S * cfg.top_k,
                     "routes_equal": True, "max_abs_err": err, "tol": tol,
                     "cpu_s": cpu_s}
    return out


def serve_arch(drive, paths, arch, prefix, steps, profiled) -> dict:
    """The DSMS serving path of ``python -m repro_torch.launch.serve`` at
    ``arch``'s full size: the engine over random weights, its plan and two
    replans (each held bit for bit to a scalar session on the same calls,
    ``sched_plan_kernel`` exact to its plain version on the instance and
    on the replans' resumed launches), then ``steps`` timed decode steps
    beside the step's byte bound, then ``profiled`` steps under
    torch.profiler.  Paths ``{prefix}_plan``, ``_retime``, ``_fault`` and
    ``_decode``."""
    cfg = get_arch(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, SERVE_BATCH, SERVE_MAX_SEQ, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(eng.params)
    assert all(t.dtype == torch.bfloat16 and t.is_cuda for t in leaves)
    weight_bytes = nbytes(leaves)
    cache_bytes = nbytes(eng.cache.values())

    ref = Scheduler(eng.topology, backend="scalar",
                    policy=HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1))
    calls, ref_last, resumed = {}, {}, []

    def held(name, fn, ref_fn):
        t = time.perf_counter()
        resumed.extend(recording_resumed(lambda: drive(name, fn))[1])
        wall = time.perf_counter() - t
        want = ref_last["plan"] = ref_fn()
        assert want.backend == "scalar"
        for f in ("proc", "start", "finish"):
            assert np.array_equal(getattr(eng.plan, f),
                                  getattr(want.schedule, f)), (name, f)
        assert eng.holes == want.holes, (name, eng.holes, want.holes)
        calls[name] = {"wall_s": wall, "makespan_s": eng.plan.makespan,
                       "sched_plan_kernel": paths[name]["sched_plan_kernel"]}

    held(f"{prefix}_plan", eng.ensure_plan, lambda: ref.submit(eng._graph))
    plan_tasks = eng._graph.n
    # sched_plan_kernel at the serving instance's shapes (the serving
    # graph, P = 4 with the node's shared bus, the 21-alpha grid) against
    # its plain version on the same card tensors
    card = eng.scheduler.submit(eng._graph)
    assert card.backend == "cuda"
    alphas = [float(a) for a in card.sweep.alphas]
    assert len(alphas) == 21, alphas
    q = eng.scheduler._sessions[id(eng._graph)].queue_for(
        eng.topology, eng.scheduler.policy)
    plan_err, _, _, plan_waves = check_plan(eng._graph, eng.topology, q,
                                            alphas, card.period)
    hub = eng._graph.pred[eng._query_nodes[0]][0]
    held(f"{prefix}_retime", lambda: eng.retime({hub: 1.3}),
         lambda: ref.update(task_rates={hub: 1.3},
                            graph=ref_last["plan"].graph))
    held(f"{prefix}_fault", lambda: eng.mark_failed(proc=3),
         lambda: ref.mark_failed(proc=3, graph=ref_last["plan"].graph))
    assert paths[f"{prefix}_plan"]["sched_plan_kernel"] == 1, paths
    # and on the staged inputs of the replans' resumed launches
    resumed_err = check_resumed(resumed)

    # the decode loop; a device-side flag gathers each step's
    # finiteness check (two small kernels a step, no sync)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step = eng._step

    def checked(*args):
        logits, cache = step(*args)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    eng._step = checked
    toks = np.zeros(SERVE_BATCH, np.int64)
    seen = []
    for _ in range(SERVE_WARMUP):
        toks = eng.step(toks).tokens
        seen.append(toks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def decode():
        nonlocal toks
        a.record()
        for _ in range(steps):
            res = eng.step(toks)
            toks = res.tokens
            seen.append(toks)
        b.record()
        return res

    last = drive(f"{prefix}_decode", decode)
    ms = a.elapsed_time(b) / steps
    decode_peak = torch.cuda.max_memory_allocated()
    assert bool(finite), f"{arch}: a logit is not finite"
    seen = np.stack(seen)
    assert seen.shape == (SERVE_WARMUP + steps, SERVE_BATCH)
    assert ((seen >= 0) & (seen < cfg.vocab)).all(), seen
    assert eng.pos == SERVE_WARMUP + steps
    assert all(v == 0 for v in paths[f"{prefix}_decode"].values()), paths
    eng._step = step                    # profile the step alone
    busy_ms, kernels, top = profiled_steps(eng, toks, profiled)
    step_bytes, step_flops, parts = step_work(
        cfg, eng, range(SERVE_WARMUP, SERVE_WARMUP + steps))
    bound_ms, bound_by = bound(int(step_bytes), step_flops, BF16_OPS_PER_S)
    out = {"arch": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "batch": SERVE_BATCH,
           "max_seq": SERVE_MAX_SEQ, "weight_bytes": weight_bytes,
           "cache_bytes": cache_bytes, "build_s": build_s,
           "max_memory_allocated_build_bytes": build_peak,
           "max_memory_allocated_decode_bytes": decode_peak,
           "plan_tasks": plan_tasks,
           "plan_calls": calls, "plan_vs_plain": {
               "alphas": len(alphas), "waves": plan_waves,
               "max_abs_err": plan_err},
           "resumed_vs_plain": resumed_err,
           "plan_makespan_s": eng.plan.makespan,
           "replans": eng.replans, "holes": {
               str(k): v for k, v in eng.holes.items()},
           "warmup_steps": SERVE_WARMUP, "steps": steps,
           "ms_per_step": ms,
           "tokens_per_s": SERVE_BATCH / ms * 1e3,
           "step_bytes": int(step_bytes), "step_bytes_parts": parts,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms,
           "profiled_steps": profiled,
           "device_busy_ms_per_step": busy_ms,
           "kernels_per_step": kernels,
           "top_kernels_ms_per_step": top,
           "idle_share": 1.0 - busy_ms / ms,
           "precise": last.precise, "precision": last.precision,
           "last_tokens": last.tokens.tolist(),
           "launches": {k: paths[f"{prefix}_{k}"] for k in (
               "plan", "retime", "fault", "decode")}}
    del eng, step, checked, last
    torch.cuda.empty_cache()
    return out


def step_work(cfg, eng, positions):
    """A decode step's least work, averaged over ``positions``: every
    weight but the embedding table read once (the table only gathered, B
    rows; the hybrid's shared block once a group, since 9 x its 210 MB
    outgrow the L2), the KV rows up to the step's position read and its
    new rows written, the SSM state and conv rows read and written, the
    logits written; 2 flops a weight a row through it (B rows; one
    capacity slot a group through each expert) at the bf16 tensor peak.
    Returns (bytes, flops, {part: bytes})."""
    p = eng.params
    embed = p["embed"]
    B, n = SERVE_BATCH, len(positions)
    weights = nbytes(tree_leaves(p)) - nbytes([embed])
    if "lm_head" not in p:                   # tied: the head reads it
        weights += nbytes([embed])
    parts = {"weights": weights, "embed_rows": B * cfg.d_model * 2,
             "logits": B * cfg.vocab * 4}
    flops = 2 * (weights // 2) * B
    if cfg.family == "moe":
        moe_bytes = nbytes(tree_leaves(p["blocks"]["moe"]))
        C = max(1, int(cfg.top_k * B / cfg.n_experts * 1.25))
        flops -= 2 * (moe_bytes // 2) * (B - C)
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        parts["shared_again"] = (G - 1) * nbytes(tree_leaves(p["shared"]))
        flops += 2 * (parts["shared_again"] // 2) * B
    c = eng.cache
    if "k" in c:                             # rows of K and V a layer
        kv_layers, row = c["k"].shape[0], 2 * B * cfg.n_kv_heads \
            * cfg.head_dim * c["k"].element_size()
        parts["kv"] = sum(kv_layers * row * (q + 2) for q in positions) // n
    for k in ("h", "conv", "ssm_h", "ssm_conv"):
        if k in c:
            parts[k] = 2 * nbytes([c[k]])
    return sum(parts.values()), flops, parts


def phase_serve(drive, paths) -> dict:
    """The DSMS serving path at qwen3-8b's full size (``serve_arch``),
    then decode against forward at full width."""
    out = {"phase": "serve", "entry": "repro_torch.launch.serve "
           "(build_engine, default_queries) -> DSMSEngine",
           **serve_arch(drive, paths, SERVE_ARCH, "serve", SERVE_STEPS,
                        SERVE_PROFILED_STEPS)}
    assert (out["n_layers"], out["d_model"]) == (36, 4096)
    out["kv_cache_bytes"] = out.pop("cache_bytes")
    out["launches"] = {f"serve_{k}": v for k, v in out["launches"].items()}
    out["decode_vs_forward"] = {
        str(dt).replace("torch.", ""): decode_vs_forward(SERVE_ARCH, 2, dt)
        for dt in (torch.bfloat16, torch.float32)}
    return out


def phase_serve_families(drive, paths) -> dict:
    """The serving path at the full size of one architecture of each
    family this port added to the serve path (``serve_arch``), then each
    family's decode check at full width: falcon-mamba (2 layers) and
    zamba2 (12 layers, 2 groups of 6) decode against forward; olmoe (2
    layers) on the card against the CPU, with equal routing; dbrx's MoE
    layer alone (the model is too large for one card)."""
    t0 = time.perf_counter()
    out = {"phase": "serve_families", "entry": "repro_torch.launch.serve "
           "(build_engine, default_queries) -> DSMSEngine", "archs": {}}
    for arch, shape in FAMILY_ARCHS.items():
        got = serve_arch(drive, paths, arch, f"serve_{arch}", FAMILY_STEPS,
                         FAMILY_PROFILED_STEPS)
        assert (got["n_layers"], got["d_model"]) == shape, (arch, got)
        out["archs"][arch] = got
    fm, zb = "falcon-mamba-7b", "zamba2-2.7b"
    out["archs"][fm]["decode_vs_forward"] = {
        str(dt).replace("torch.", ""): decode_vs_forward(fm, 2, dt)
        for dt in (torch.bfloat16, torch.float32)}
    out["archs"][zb]["decode_vs_forward"] = hybrid_decode_vs_forward(
        zb, 12, 6)
    torch.cuda.empty_cache()
    out["archs"]["olmoe-1b-7b"]["card_vs_cpu"] = moe_card_vs_cpu(
        "olmoe-1b-7b", 2)
    torch.cuda.empty_cache()
    out["dbrx-132b_moe_layer"] = moe_layer_card_vs_cpu("dbrx-132b")
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def train_flops(cfg, batch, seq) -> int:
    """A train step's model FLOPs, PaLM's count: 6 N a token (N =
    ``param_count``, the tied table once, as the head's matmul) plus
    12 L H dh S a token for attention's two products, forward and
    backward, over every score (the model computes the whole square);
    remat's recomputed forward is not counted."""
    per_token = 6 * cfg.param_count() + \
        12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq
    return batch * seq * per_token


def train_restart(step_fn, pipe, cfg, straight) -> dict:
    """The launcher's restart at full size: ``TRAIN_RESTART`` steps from a
    fresh state with a checkpoint after the last (the launcher's
    ``train_loop``, under the checkout's build/), ``resume`` into a tree
    of the state's structure, as many more steps.  The restored params,
    mu, nu and step equal the state that was saved bit for bit, and
    every loss equals the straight run's at ``TRAIN_RESTART_RTOL``.  As
    a control, how many of the saved leaves differ from a fresh state's
    (a restore of step 0, or mu and nu reset, would equal those)."""
    ck = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    n = TRAIN_RESTART
    params, opt = init_state(cfg, 0, "cuda")
    t0 = time.perf_counter()
    saved = train_loop(step_fn, pipe, params, opt, 0, n, "cuda", str(ck), n,
                       log=None)
    loop_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in ck.rglob("*.npy"))
    del params, opt
    torch.cuda.empty_cache()
    shape = tree_map(lambda _: None, param_specs(cfg))
    t0 = time.perf_counter()
    params, opt, start = resume(str(ck), shape,
                                OptState(shape, shape, None), "cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert start == n and int(opt.step) == n, (start, opt.step)
    first = saved[2]
    got, was, fresh = ([leaf for _, leaf in ckpt_paths({"p": t[0], "o": t[1]})]
                       for t in ((params, opt), saved,
                                 init_state(cfg, 0, "cuda")))
    unequal = [i for i, (g, w) in enumerate(zip(got, was))
               if not torch.equal(g, w)]
    if len(got) != len(was) or unequal:
        raise AssertionError(f"restart: {len(unequal)} of {len(was)} "
                             f"restored leaves (params, mu, nu, step) differ "
                             f"from the saved state's, first {unequal[:1]}")
    n_leaves = len(was)
    unlike_fresh = sum(not torch.equal(w, f) for w, f in zip(was, fresh))
    del saved, got, was, fresh
    params, opt, rest = train_loop(step_fn, pipe, params, opt, n, 2 * n,
                                   "cuda", log=None)
    del params, opt
    shutil.rmtree(ck)
    got = [i["loss"] for i in first + rest]
    want = straight[:2 * n]
    if not np.allclose(got, want, rtol=TRAIN_RESTART_RTOL, atol=0):
        raise AssertionError(f"restart losses {got} against the straight "
                             f"run's {want}")
    return {"steps": [n, n], "losses": got, "straight_losses": want,
            "max_rel_err": max(abs(g - w) / abs(w)
                               for g, w in zip(got, want)),
            "rtol": TRAIN_RESTART_RTOL, "checkpoint_bytes": ckpt_bytes,
            "state_leaves_bit_equal": len(unequal) == 0,
            "state_leaves": n_leaves,
            "state_leaves_unlike_fresh_state": unlike_fresh,
            "steps_and_save_s": loop_s, "restore_s": restore_s}


def leaf_names(tree):
    """The leaves' key paths, in ``tree_leaves`` order (the checkpoint's
    file names without their prefix)."""
    return ["/".join(path) for path, _ in ckpt_paths(tree)]


def train_step_leaves(cfg, params, batch):
    """One train step as ``make_train_step`` runs it, split to be read:
    ``loss_and_grads`` (remat on), then ``adamw_update`` from a fresh
    state (its mu and nu one zero tree, which AdamW only reads).  Returns
    [loss] + the gradient leaves + the updated parameter leaves."""
    loss, grads = loss_and_grads(cfg, params, batch)
    zeros = tree_map(torch.zeros_like, params)
    new, _, _ = adamw_update(AdamWConfig(), params, grads, OptState(
        zeros, zeros, torch.zeros((), dtype=torch.int32,
                                  device=loss.device)))
    return [loss] + tree_leaves(grads) + tree_leaves(new)


def train_card_vs_cpu(arch) -> dict:
    """One train step of ``arch`` at full width, cut to
    ``TRAIN_PARITY_LAYERS``, batch ``TRAIN_PARITY_BATCH`` of
    ``TRAIN_PARITY_SEQ`` tokens, on the card against the same step on
    the CPU from the same f32 masters: the loss, every gradient and every
    updated parameter in f64 elementwise at ``F64_TOL``, and in f32 (TF32
    off) each by relative RMS within ``F32_GAP_RATIO`` times the CPU's own
    f32 error on it (against its f64 result).  Every MoE call of the f64
    runs routes the same on the card and the CPU; the f32 runs take those
    picks (``routed``): at this width the router's f32 probabilities
    differ from f64 by ~3e-5, more than the closest gaps between a
    token's 8th and 9th expert, so each f32 run would break a near-tie
    its own way and the two runs would part (the moved tokens are
    reported).  The CPU runs first and its leaves are held on the card
    one at a time."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=TRAIN_PARITY_LAYERS)
    masters = cut_params(cfg, 1)
    host = tree_map(lambda a: a.cpu(), masters)
    n_params = sum(a.numel() for a in tree_leaves(host))
    names = ["loss"] + [f"grad {n}" for n in leaf_names(host)] + \
        [f"param {n}" for n in leaf_names(host)]
    batch = SyntheticTokenPipeline(cfg, ShapeConfig(
        "t", TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH, "train")).batch_for_step(0)
    runs, picks, wall = {}, {}, {}
    for name in ("float64", "float32"):
        c = dataclasses.replace(cfg, dtype=name)
        forced = picks["float64", "cpu"] if name == "float32" else None
        for where, p, dev in (("cpu", host, torch.device("cpu")),
                              ("card", masters, torch.device("cuda"))):
            p = tree_map(lambda a: a.to(DTYPES[name]), p)
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
            t0 = time.perf_counter()
            runs[name, where], picks[name, where] = routed(
                lambda: train_step_leaves(c, p, b), forced)
            torch.cuda.synchronize()
            wall[f"{name}_{where}_s"] = time.perf_counter() - t0
            del p, b
    del masters, host
    a, b = picks["float64", "card"], picks["float64", "cpu"]
    if not (len(a) == len(b) and all(map(torch.equal, a, b))):
        raise AssertionError(f"{arch}: the card and the CPU routed tokens "
                             f"to other experts in f64")
    # the f32 runs took the f64 picks; how many tokens their own picks
    # would have moved (near-ties that f32 breaks the other way)
    moved = {w: sum(int((x != y).any(-1).sum()) for x, y in zip(
        picks["float32", w], b)) for w in ("card", "cpu")}
    f64_err = max(hold(f"{arch} train step card vs cpu float64 {n}", g,
                       w.to(g.device), F64_TOL)
                  for n, g, w in zip(names, runs["float64", "card"],
                                     runs["float64", "cpu"]))
    worst = {"ratio": 0.0}
    for n, g, w, e in zip(names, runs["float32", "card"],
                          runs["float32", "cpu"], runs["float64", "cpu"]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{arch} train step on the card: {n} "
                                 f"not finite")
        gap, error = rel_rms(g, w.to(g.device)), rel_rms(w, e)
        if not gap <= F32_GAP_RATIO * error:
            raise AssertionError(f"{arch} train step card vs cpu float32 "
                                 f"{n}: relative RMS {gap} above "
                                 f"{F32_GAP_RATIO} x the CPU's f32 error "
                                 f"{error}")
        if gap / error > worst["ratio"]:
            worst = {"leaf": n, "ratio": gap / error, "rel_rms": gap,
                     "error": error}
    loss32 = [float(runs["float32", w][0]) for w in ("card", "cpu")]
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
            "params": n_params,
            "leaves_held": len(names), "moe_calls": len(b),
            "f64_routes_equal": True,
            "f32_own_picks_moved_tokens": moved,
            "float64": {"max_abs_err": f64_err, "tol": F64_TOL,
                        "loss": float(runs["float64", "card"][0])},
            "float32": {"loss_card_cpu": loss32,
                        "limit_ratio": F32_GAP_RATIO, "worst": worst},
            "wall_s": wall}


def phase_train(drive, paths) -> dict:
    """The training path of ``python -m repro_torch.launch.train`` at
    qwen2-0.5b's full size: ``init_state``, the synthetic pipeline,
    ``make_train_step`` and ``train_loop``; ``TRAIN_STEPS`` steps timed
    with CUDA events after ``TRAIN_WARMUP`` (path ``train``), one more
    under torch.profiler; every loss and grad norm finite; then the
    restart at full size and one step of the card against the CPU at
    full width for each of ``TRAIN_PARITY``."""
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    seq = SHAPES["train_4k"].seq_len
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("train", seq, TRAIN_BATCH,
                                                   "train"))
    total = TRAIN_WARMUP + TRAIN_STEPS + 1
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=total),
                              microbatch=TRAIN_MICROBATCH)
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_state(cfg, 0, "cuda")
    weight_bytes = nbytes(tree_leaves(params))
    opt_bytes = nbytes(tree_leaves(opt.mu) + tree_leaves(opt.nu))
    infos = []

    def run(start, stop):
        # one step a call, as the launcher steps: the state held here is
        # each step's input, not the first step's through every step
        nonlocal params, opt
        for s in range(start, stop):
            params, opt, got = train_loop(step_fn, pipe, params, opt, s,
                                          s + 1, "cuda", log=None)
            infos.extend(got)

    run(0, TRAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        a.record()
        run(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
        b.record()

    drive("train", timed)
    ms = a.elapsed_time(b) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    assert all(v == 0 for v in paths["train"].values()), paths["train"]
    busy_ms, kernels, top = device_trace(lambda: run(total - 1, total), 1)
    del params, opt
    torch.cuda.empty_cache()
    losses = [i["loss"] for i in infos]
    gnorms = [i["grad_norm"] for i in infos]
    if not (all(math.isfinite(x) for x in losses + gnorms)
            and all(g > 0 for g in gnorms)):
        raise AssertionError(f"train: losses {losses}, grad norms {gnorms}")
    t0 = time.perf_counter()
    pipe.batch_for_step(0)
    batch_ms = (time.perf_counter() - t0) * 1e3
    flops = train_flops(cfg, TRAIN_BATCH, seq)
    out = {"phase": "train", "entry": "repro_torch.launch.train "
           "(init_state, SyntheticTokenPipeline, make_train_step, "
           "train_loop)", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": cfg.dtype, "seq": seq, "batch": TRAIN_BATCH,
           "microbatch": TRAIN_MICROBATCH, "remat": True,
           "weight_bytes": weight_bytes, "opt_state_bytes": opt_bytes,
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * seq / ms * 1e3,
           "model_flops_per_step": flops,
           "mfu": flops / (ms * 1e-3) / BF16_OPS_PER_S,
           "max_memory_allocated_bytes": peak,
           "profiled_steps": 1, "device_busy_ms_per_step": busy_ms,
           "kernels_per_step": kernels, "top_kernels_ms_per_step": top,
           "idle_share": 1.0 - busy_ms / ms,
           "host_batch_ms": batch_ms,
           "losses": losses, "grad_norms": gnorms,
           "lr": [i["lr"] for i in infos],
           "launches": paths["train"]}
    assert (out["n_layers"], out["d_model"]) == (24, 896)
    out["restart"] = train_restart(step_fn, pipe, cfg, losses)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = {}
    for arch in TRAIN_PARITY:
        out["card_vs_cpu"][arch] = train_card_vs_cpu(arch)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def mesh_launcher(drive, train) -> dict:
    """The launcher's path at ``--mesh 1x1``: a one-rank NCCL group, a
    (1, 1) DeviceMesh over ("data", "model"), ``init_state`` under it
    (every parameter and optimizer leaf a DTensor) and ``train_loop`` with
    the batch laid out by ``batch_shardings``, at the train phase's size,
    seed and schedule; ``MESH_STEPS`` steps (path ``mesh_train``), each
    timed on the host clock to a synchronize (the first builds DTensor's
    layout caches).  Losses and grad norms against the train phase's."""
    cfg = get_arch(TRAIN_ARCH)
    seq = SHAPES["train_4k"].seq_len
    shape = ShapeConfig("train", seq, TRAIN_BATCH, "train")
    pipe = SyntheticTokenPipeline(cfg, shape)
    step_fn = make_train_step(
        cfg, AdamWConfig(total_steps=TRAIN_WARMUP + TRAIN_STEPS + 1),
        microbatch=TRAIN_MICROBATCH)
    own = start_group("cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with use_sharding(mesh):
            params, opt = init_state(cfg, 0, "cuda")
            leaves = tree_leaves(params) + tree_leaves(opt.mu) + \
                tree_leaves(opt.nu) + [opt.step]
            assert all(isinstance(x, DTensor) for x in leaves)
            # the steps replace the state: a list kept here would hold the
            # first one on the card through every step
            del leaves
            place = batch_shardings(cfg, shape)
            infos, step_ms = [], []

            def run():
                nonlocal params, opt
                for s in range(MESH_STEPS):
                    t0 = time.perf_counter()
                    params, opt, got = train_loop(
                        step_fn, pipe, params, opt, s, s + 1, "cuda",
                        log=None, placements=place)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    infos.extend(got)

            drive("mesh_train", run)
            assert all(isinstance(x, DTensor) for x in tree_leaves(params))
            peak = torch.cuda.max_memory_allocated()
            reset_all_launches()
            ckpt = mesh_checkpoint(cfg, params, opt)
            assert all(v == 0 for v in all_launches().values())
            del params, opt
    finally:
        if own:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want = train["losses"][:MESH_STEPS], train["grad_norms"][:MESH_STEPS]
    got = [i["loss"] for i in infos], [i["grad_norm"] for i in infos]
    if not (np.allclose(got[0], want[0], rtol=TRAIN_RESTART_RTOL, atol=0)
            and np.allclose(got[1], want[1], rtol=MESH_GNORM_RTOL, atol=0)):
        raise AssertionError(f"mesh 1x1 losses {got[0]}, grad norms "
                             f"{got[1]} against the train phase's {want}")
    steady = step_ms[1:]
    return {"entry": "repro_torch.launch.train --mesh 1x1 (start_group, "
                     "make_mesh, init_state, train_loop)",
            "backend": "nccl", "mesh": {"data": 1, "model": 1},
            "arch": cfg.name, "n_layers": cfg.n_layers, "seq": seq,
            "batch": TRAIN_BATCH, "microbatch": TRAIN_MICROBATCH,
            "losses": got[0], "grad_norms": got[1],
            "train_losses": want[0], "train_grad_norms": want[1],
            "losses_bit_equal": got[0] == want[0],
            "grad_norms_bit_equal": got[1] == want[1],
            "rtol": {"loss": TRAIN_RESTART_RTOL,
                     "grad_norm": MESH_GNORM_RTOL},
            "step_ms": step_ms, "first_step_ms": step_ms[0],
            "ms_per_step": sum(steady) / len(steady),
            "meshless_ms_per_step": train["ms_per_step"],
            "max_memory_allocated_bytes": peak,
            "memory_allocated_before_bytes": before,
            "own_peak_bytes": peak - before, "checkpoint": ckpt}


def mesh_checkpoint(cfg, params, opt) -> dict:
    """The sharded checkpoint on the launcher's one-rank NCCL (1, 1)
    mesh at full size: ``save`` (each rank's shards to the host, written
    into the files) and ``restore`` (each rank's rows read from the
    files, then moved to the card) of the state the mesh steps left.
    Every restored leaf is a DTensor of the saved placements, bit-equal
    to the saved one; the save's device peak, measured from a reset,
    stays within ``MESH_CKPT_SLACK`` of the bytes allocated before it
    (no leaf is copied on the card)."""
    d = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    state = {"p": params, "o": opt}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt_save(d, 1, state)
    save_s = time.perf_counter() - t0
    save_peak = torch.cuda.max_memory_allocated()
    if save_peak > before + MESH_CKPT_SLACK:
        raise AssertionError(f"checkpoint save: device peak {save_peak} "
                             f"bytes, {before} allocated before it")
    disk = sum(f.stat().st_size for f in (d / "step_1").iterdir())
    t0 = time.perf_counter()
    back = ckpt_restore(d, 1, state, "cuda", {"p": param_shardings(cfg),
                                              "o": opt_shardings(cfg)})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved, got = ckpt_paths(state), ckpt_paths(back)
    n = 0
    for (k, a), (k2, b) in zip(saved, got):
        if not (k == k2 and isinstance(b, DTensor)
                and b.placements == a.placements
                and torch.equal(a.to_local(), b.to_local())):
            raise AssertionError(f"checkpoint: leaf {k} restored unequal")
        n += 1
    del back
    shutil.rmtree(d)
    return {"entry": "repro_torch.checkpoint save / restore(placements=)",
            "mesh": {"data": 1, "model": 1}, "backend": "nccl",
            "leaves": n, "bit_equal": True, "file_bytes": disk,
            "save_s": save_s, "restore_s": restore_s,
            "save_max_memory_allocated_bytes": save_peak,
            "allocated_before_save_bytes": before,
            "save_device_growth_bytes": save_peak - before,
            "slack_bytes": MESH_CKPT_SLACK}


DRYRUN_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import repro_torch.launch.dryrun as D
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_mesh
for cell in json.loads(sys.argv[2]):
    print(json.dumps(D.run_cell(*cell)), flush=True)
arch, seq, batch, micro = json.loads(sys.argv[3])
D.fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
print(json.dumps({"launcher_step": D.step_memory(
    arch, ShapeConfig("train", seq, batch, "train"), mesh,
    microbatch=micro)}), flush=True)
"""


def mesh_dryrun(launcher) -> dict:
    """``launch/dryrun.py``'s ``run_cell`` on each of ``DRYRUN_CELLS`` at
    full size, in a process of its own that sees no card (its fake group
    must not meet this process's); every rank's state under the card's
    memory, and no all-gather in a train cell as large as one rank's
    (B, S, V) f32 logits gathered over the vocabulary.  Each cell's peak
    (state and activations) is reported against the card's memory, not
    asserted.  Then ``step_memory`` of ``launcher``'s own step (the same
    cell on a (1, 1) mesh over meta tensors) against the bytes the card
    allocated for it: the launcher's peak less what was allocated before
    it began, within ``DRYRUN_PEAK_RATIO``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    own = [launcher["arch"], launcher["seq"], launcher["batch"],
           launcher["microbatch"]]
    out = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT,
                          str(ROOT / "src"), json.dumps(DRYRUN_CELLS),
                          json.dumps(own)],
                         capture_output=True, text=True, env=env)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise RuntimeError(f"the dry run failed:\n{out.stderr[-4000:]}")
    card = torch.cuda.get_device_properties(0).total_memory
    recs = list(map(json.loads, out.stdout.splitlines()))
    step = recs.pop()["launcher_step"]
    ratio = step["peak_bytes"] / launcher["own_peak_bytes"]
    if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
        raise AssertionError(f"dry-run peak {step['peak_bytes']} bytes of "
                             f"the launcher's step, the card's "
                             f"{launcher['own_peak_bytes']}")
    cells = {}
    for rec in recs:
        name = f"{rec['arch']}/{rec['shape']}/{rec['mesh']}"
        mem = rec["memory"]
        if not mem["total_bytes"] < card:
            raise AssertionError(f"dry run {name}: {mem['total_bytes']} "
                                 f"bytes a rank, the card has {card}")
        shape = SHAPES[rec["shape"]]
        if shape.kind == "train":
            cfg = get_arch(rec["arch"])
            ways = rec["chips"] // 16
            logits = shape.global_batch // ways * shape.seq_len * \
                cfg.vocab * 4
            gather = rec["collectives"].get("all_gather_into_tensor", {})
            if not gather.get("max_result_bytes", 0) < logits:
                raise AssertionError(f"dry run {name}: an all-gather of "
                                     f"{gather} bytes, the logits {logits}")
        cells[name] = {"ranks": rec["chips"], "memory": mem,
                       "peak_bytes": mem["peak_bytes"],
                       "temp_bytes": mem["temp_bytes"],
                       "peak_over_card": mem["peak_bytes"] > card,
                       "flops_per_rank": rec["cost"]["flops"],
                       "collectives": rec["collectives"],
                       "wall_s": rec["lower_s"]}
    assert len(cells) == len(DRYRUN_CELLS), cells
    return {"entry": "repro_torch.launch.dryrun.run_cell",
            "card_total_memory_bytes": card, "cells": cells,
            "launcher_step": {
                "entry": "repro_torch.launch.dryrun.step_memory",
                "mesh": {"data": 1, "model": 1}, "memory": step,
                "peak_bytes": step["peak_bytes"],
                "card_max_memory_allocated_bytes":
                    launcher["max_memory_allocated_bytes"],
                "card_allocated_before_bytes":
                    launcher["memory_allocated_before_bytes"],
                "card_own_peak_bytes": launcher["own_peak_bytes"],
                "ratio_to_own_peak": ratio,
                "ratio_to_max_memory_allocated":
                    step["peak_bytes"] / launcher[
                        "max_memory_allocated_bytes"],
                "limits": DRYRUN_PEAK_RATIO},
            "process_wall_s": wall}


def mesh_cpu_rank(rank, store, out, cases):
    """One of 4 CPU ranks: each case of ``mesh_cpu_case`` (its arch's
    config at full width, cut to ``MESH_CPU_LAYERS``, in f64) on a (2, 2)
    mesh: one train step from seed-1 masters on step 0's batch, as
    ``make_train_step`` makes it (``loss_and_grads``, then
    ``adamw_update`` from a fresh state).  Each rank saves the loss, the
    grad norm, and its own shards of every gradient and updated parameter
    with their places (``<out>/<arch>.<rank>.pt``): gathering them over
    gloo would take longer than the step."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")

        def shards(tree):
            return [(a.to_local(), compute_local_shape_and_global_offset(
                a.shape, mesh, a.placements)[1], tuple(a.shape))
                for a in tree_leaves(tree)]

        for arch, (cfg, pipe) in cases.items():
            with use_sharding(mesh):
                params = mesh_cpu_masters(cfg)
                loss, grads = loss_and_grads(cfg, params, pipe.device_batch(
                    0, "cpu", batch_shardings(cfg, pipe.shape)), remat=False)
                new, _, info = adamw_update(AdamWConfig(), params, grads,
                                            init_opt_state(params))
                torch.save({"loss": full(loss),
                            "grad_norm": info["grad_norm"],
                            "grads": shards(grads), "params": shards(new)},
                           Path(out) / f"{arch}.{rank}.pt")
                del params, grads, new
    finally:
        dist.destroy_process_group()


def mesh_cpu_whole(work, arch):
    """The 4 ranks' results of ``arch``: rank 0's loss and grad norm, and
    every gradient and updated parameter put together whole from the
    ranks' shards (on the host: the card holds the reference's)."""
    whole = {}
    for rank in range(4):
        part = torch.load(work / f"{arch}.{rank}.pt")
        if rank == 0:
            whole = {k: part[k] for k in ("loss", "grad_norm")}
        for key in ("grads", "params"):
            if rank == 0:
                whole[key] = [torch.empty(shape, dtype=a.dtype)
                              for a, _, shape in part[key]]
            for dst, (a, offset, _) in zip(whole[key], part[key]):
                dst[tuple(slice(o, o + n) for o, n in zip(
                    offset, a.shape))] = a
        del part
    return whole


def mesh_cpu_case(arch):
    cfg = dataclasses.replace(get_arch(arch), n_layers=MESH_CPU_LAYERS,
                              dtype="float64")
    return cfg, SyntheticTokenPipeline(cfg, ShapeConfig(
        "t", MESH_CPU_SEQ, MESH_CPU_BATCH, "train"))


def mesh_cpu_masters(cfg):
    """Seed-1 masters of ``cfg`` on the CPU in f64, laid out on the active
    mesh (each rank keeps its shards of the f32 draw, then widens them)."""
    params = distribute_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    return tree_map(lambda a: a.to(torch.float64), params)


def mesh_cpu() -> dict:
    """``MESH_CPU_ARCHS`` on 4 CPU ranks (gloo, a ``FileStore`` under the
    checkout's build/) against one rank without a mesh, on the card,
    where it takes seconds where the host's CPU takes minutes (in f64 the
    card's sums part from the CPU's by ~1e-14, the train phase's
    card-against-CPU step): the loss and every gradient against the
    card's, the grad norm and every updated parameter against AdamW on
    the card from the ranks' gradients, each held at ``MESH_CPU_RTOL``,
    relative by norm."""
    work = ROOT / "build" / "mesh_cpu"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cases = {arch: mesh_cpu_case(arch) for arch in MESH_CPU_ARCHS}
    t0 = time.perf_counter()
    mp.start_processes(mesh_cpu_rank, args=(str(work / "store"), str(work),
                                            cases),
                       nprocs=4, join=True, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    out = {"mesh": {"data": 2, "model": 2}, "backend": "gloo",
           "reference": "one rank, no mesh, on the card",
           "n_layers": MESH_CPU_LAYERS, "batch": MESH_CPU_BATCH,
           "seq": MESH_CPU_SEQ, "dtype": "float64", "rtol": MESH_CPU_RTOL,
           "ranks_wall_s": ranks_s, "archs": {}}
    for arch, (cfg, pipe) in cases.items():
        t1 = time.perf_counter()
        params = tree_map(lambda a: a.cuda(), mesh_cpu_masters(cfg))
        loss, grads = loss_and_grads(cfg, params, pipe.device_batch(
            0, "cuda"), remat=False)
        g = mesh_cpu_whole(work, arch)
        names = leaf_names(params)
        # the update from the ranks' own gradients: AdamW is elementwise,
        # so this holds the update on shards apart from the gradients'
        # sums (AdamW's first step divides a gradient near its eps by
        # itself, turning a 1e-18 difference into 1e-10 of the update)
        mine = iter([a.cuda() for a in g["grads"]])
        new, _, info = adamw_update(
            AdamWConfig(), params, tree_map(lambda _: next(mine), params),
            init_opt_state(params))
        torch.cuda.synchronize()
        del params
        pairs = ([("loss", g["loss"], loss),
                  ("grad_norm", g["grad_norm"], info["grad_norm"])]
                 + [(f"grad {n}", a, b) for n, a, b in zip(
                     names, g["grads"], tree_leaves(grads))]
                 + [(f"param {n}", a, b) for n, a, b in zip(
                     names, g["params"], tree_leaves(new))])
        worst, peak = (-1.0, ""), (-1.0, "")
        for name, a, b in pairs:
            a, b = a.double().cuda(), b.double()
            err = float((a - b).norm() / b.norm().clamp_min(1e-300))
            if not err <= MESH_CPU_RTOL:
                raise AssertionError(f"mesh cpu {arch} {name}: relative "
                                     f"error {err}")
            worst = max(worst, (err, name))
            peak = max(peak, (float((a - b).abs().max() / b.abs().max()
                                    .clamp_min(1e-300)), name))
        out["archs"][arch] = {"d_model": cfg.d_model,
                              "loss": float(g["loss"]),
                              "grad_norm": float(g["grad_norm"]),
                              "leaves_held": len(pairs),
                              "rel_err": worst[0], "worst": worst[1],
                              "max_abs_over_max": peak[0],
                              "max_abs_worst": peak[1],
                              "one_rank_s": time.perf_counter() - t1}
        del grads, new, g
        torch.cuda.empty_cache()
    shutil.rmtree(work)
    return out


def token_nll_vs_torch() -> dict:
    """The loss head on the card at the train phase's logits (one
    microbatch of qwen2-0.5b, f32): ``loss_fn``'s ``_TokenNLL`` against
    ``torch.logsumexp`` less the ``gather``ed gold logit, which it
    replaced so that a split vocabulary is never gathered; the mean and
    its gradient bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (TRAIN_BATCH // TRAIN_MICROBATCH, SHAPES["train_4k"].seq_len,
             get_arch(TRAIN_ARCH).vocab)
    x = torch.randn(shape, generator=g, device="cuda") * 8
    labels = torch.randint(0, shape[-1], shape[:2], generator=g,
                           device="cuda")
    a = x.clone().requires_grad_()
    want = (torch.logsumexp(a, -1) - a.gather(
        -1, labels[..., None])[..., 0]).mean()
    ga, = torch.autograd.grad(want, a)
    del a
    b = x.requires_grad_()
    got = M._TokenNLL.apply(b, labels).mean()
    gb, = torch.autograd.grad(got, b)
    equal = bool(torch.equal(got, want)) and bool(torch.equal(ga, gb))
    del b, ga, gb, x
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("the loss head parts from torch.logsumexp and "
                             "gather on the card")
    return {"shape": list(shape), "loss": float(got.detach()),
            "bit_equal": equal}


def phase_mesh(drive, paths, train) -> dict:
    """The sharding path: the launcher at ``--mesh 1x1`` on the card
    against the train phase, the full-size dry run, and 4 CPU ranks
    against one."""
    t_phase = time.perf_counter()
    out = {"phase": "mesh", "launcher": mesh_launcher(drive, train)}
    assert all(v == 0 for v in paths["mesh_train"].values()), paths
    out["loss_head"] = token_nll_vs_torch()
    t0 = time.perf_counter()
    out["dryrun"] = mesh_dryrun(out["launcher"])
    out["dryrun"]["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cpu_ranks"] = mesh_cpu()
    out["cpu_ranks"]["phase_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t_build = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        futures = [ex.submit(f) for f in (K.build_library, FA.build_library,
                                          SS.build_library)]
        built = [f.result() for f in futures]
    built[0] = built[0].built
    build_wall = time.perf_counter() - t_build
    attn_ptxas = attention_ptxas(built[1].log)
    assert len(attn_ptxas) == 2 * len(FA.HEAD_DIMS), attn_ptxas
    for name, lines in attn_ptxas.items():
        # no attention instance spills, and ptxas serializes no wgmma
        assert any(" 0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in lines), (name, lines)
        if name.startswith("wgmma_bf16"):
            assert not any("Performance Loss" in ln for ln in lines), \
                (name, lines)
    # nor does any instance of the scan kernel (one per dtype and N)
    scan_ptxas = ptxas_summary(built[2].log)
    assert len(scan_ptxas) == 12 and all(
        spill == 0 for _, spill in scan_ptxas.values()), scan_ptxas
    # every instantiation of the scheduling kernels (two kernels, four
    # walks each, in double and in float: mangled ...IdLi... / ...IfLi...)
    # spills nothing
    sched_ptxas = ptxas_summary(built[0].log)
    assert len(sched_ptxas) == 16 and all(
        sum(k in name and f"I{t}Li" in name for name in sched_ptxas) == 4
        for k in ("sched_plan_kernel", "sched_wave_kernel")
        for t in "df") and all(
        spill == 0 for _, spill in sched_ptxas.values()), sched_ptxas
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "build_wall_s": build_wall, "libraries": [
              {"name": b.name, "path": str(b.path.relative_to(ROOT)),
               "flags": " ".join(b.flags), "build_s": b.build_seconds,
               "ptxas": ptxas_summary(b.log)} for b in built],
          "attention_ptxas": attn_ptxas})

    # ---- 2. kernels against their plain versions on the card
    gp, tgp = paper_spg(), paper_topology()
    _, qp = queue_of(gp, tgp)
    grid = [k * 0.01 for k in range(301)]
    e_w_paper, _, _ = check_waves(gp, tgp, qp, 1.06, 150.0)
    e_p_paper, _, _, _ = check_plan(gp, tgp, qp, grid, 150.0)

    g7, tg7 = exp7_instance()
    _, q7 = queue_of(g7, tg7)
    period7 = g7.default_period(tg7.rates, tg7.n_procs)
    e_w7, n_waves7, (wargs, ko, kst, wb) = check_waves(
        g7, tg7, q7, 1.0, period7, timed_wave=16)
    e_p7, pargs, pouts, _ = check_plan(g7, tg7, q7, grid, period7)
    emit({"phase": "kernels_vs_plain", "exact": True,
          "paper": {"wave_max_abs_err": e_w_paper,
                    "plan_max_abs_err": e_p_paper},
          "exp7": {"waves": n_waves7, "alphas": len(grid),
                   "wave_max_abs_err": e_w7, "plan_max_abs_err": e_p7}})

    W, B = pargs["task"].shape
    A = len(grid)
    times = sched_kernel_times(wargs, (ko, kst), wb, pargs, pouts)
    k1_ms, k1_plain_ms, k1_bound, k1_by = (
        times["exp7_wave"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by"))
    k2_ms, k2_plain_ms, k2_bound, k2_by = (
        times["exp7_plan"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by"))
    emit({"phase": "kernel_times", "card": smi, **times})

    # ---- 3. main path, paper instance.  Every path is driven with the
    # launch counts set to 0 just before it and read just after it.
    paths = {}

    def drive(name, fn):
        reset_all_launches()
        result = fn()
        torch.cuda.synchronize()
        paths[name] = all_launches()
        return result

    sched = Scheduler(tgp)
    hsv, hv, ic = drive("paper_submit", lambda: (
        sched.submit(gp, HSV_CC()), sched.submit(gp, HVLB_CC_B(**PAPER_POLICY)),
        sched.submit(gp, HVLB_CC_IC(**PAPER_POLICY))))
    finite_holes = {t: h for t, h in ic.holes.items() if np.isfinite(h)}
    assert hsv.backend == hv.backend == ic.backend == "cuda"
    assert hsv.makespan == 73.0, hsv.makespan
    assert hv.makespan == 62.0 and hv.best_alpha == 1.06, \
        (hv.makespan, hv.best_alpha)
    assert finite_holes == {0: 1.0, 5: 4.0}, ic.holes
    assert schedule_violations(hv.schedule) == []
    # the per-wave path through the engine: one sched_wave_kernel launch
    # per wave, the same schedule as the whole-plan launch
    inst_p = CompiledInstance(gp, tgp, rank=rank_matrix(gp, tgp))
    wave_s = drive("paper_per_wave", lambda: inst_p.schedule(
        qp, 1.06, period=150.0, backend=CudaBackend(inst_p, scan=False)))
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(wave_s, f), getattr(hv.schedule, f))
    emit({"phase": "main_paper", "hsv_makespan": hsv.makespan,
          "hvlb_makespan": hv.makespan, "best_alpha": hv.best_alpha,
          "holes": {f"n{t + 1}": h for t, h in finite_holes.items()},
          "backend": hv.backend, "launches": {
              k: paths[k] for k in ("paper_submit", "paper_per_wave")}})

    # ---- 4. main path, exp7 deployment: 301 alphas in one launch
    sched7 = Scheduler(tg7)
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan7 = drive("exp7_submit", lambda: sched7.submit(g7, EXP7_POLICY))
    submit_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    sess = sched7._sessions[id(g7)]       # the session's compiled state
    be7 = sess.inst.backend_instance("cuda")
    timing = dict(be7.last_timing)
    assert plan7.backend == "cuda"
    assert schedule_violations(plan7.schedule) == []
    # against the port's host reference: every grid makespan, the best
    # schedule, and the full decision traces of four more alphas, those
    # the session keeps nearest 0, 0.75, 1.5 and 2.25 (it keeps the
    # traces of the alphas the host loop simulates, as the reference does)
    t1 = time.perf_counter()
    ref_sched = Scheduler(tg7, backend="scalar")
    ref = ref_sched.submit(g7, EXP7_POLICY)
    scalar_s = time.perf_counter() - t1
    assert np.array_equal(plan7.sweep.alphas, ref.sweep.alphas)
    assert np.array_equal(plan7.sweep.makespans, ref.sweep.makespans)
    assert plan7.best_alpha == ref.best_alpha
    kept = sorted(sess.traces[EXP7_POLICY])
    assert plan7.best_alpha in kept and kept == sorted(
        ref_sched._sessions[id(g7)].traces[EXP7_POLICY])
    checked = [plan7.best_alpha] + [min(kept, key=lambda a: abs(a - x))
                                    for x in (0.0, 0.75, 1.5, 2.25)]
    q7s = sess.queue_for(tg7, EXP7_POLICY)
    inst_s = CompiledInstance(g7, tg7, rank=sess.rank, device="cpu")
    for a in checked:
        s_ref, _, tr_ref = inst_s.schedule_traced(
            q7s, a, period=plan7.period, backend="scalar")
        tr = sess.traces[EXP7_POLICY][a]
        assert tr.records == tr_ref.records, a
    s_best, _, _ = inst_s.schedule_traced(
        q7s, plan7.best_alpha, period=plan7.period, backend="scalar")
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(plan7.schedule, f), getattr(s_best, f))
    assert plan7.schedule.messages == s_best.messages
    # the per-wave path at the deployment's size: one launch and one
    # fetch per wave, the same best schedule as the fused sweep
    inst7 = CompiledInstance(g7, tg7, rank=sess.rank)
    t2 = time.perf_counter()
    wave7 = drive("exp7_per_wave", lambda: inst7.schedule(
        q7s, plan7.best_alpha, period=plan7.period,
        backend=CudaBackend(inst7, scan=False)))
    per_wave_s = time.perf_counter() - t2
    for f in ("proc", "start", "finish"):
        assert np.array_equal(getattr(wave7, f), getattr(plan7.schedule, f))
    assert wave7.messages == plan7.schedule.messages
    emit({"phase": "main_exp7", "P": tg7.n_procs, "n": g7.n,
          "edges": len(g7.edges), "waves": W, "alphas": A,
          "makespan": plan7.makespan, "best_alpha": plan7.best_alpha,
          "submit_s": submit_s, "timing_s": timing,
          "plan_kernel_event_ms": k2_ms,
          "plan_kernel_output_bytes": nbytes(pouts[0].tensors()),
          "max_memory_allocated_bytes": peak_bytes,
          "memory_allocated_before_bytes": base_bytes,
          "roundtrips": be7.n_roundtrips, "state_uploads":
          be7.n_state_uploads, "scalar_sweep_s": scalar_s,
          "per_wave_schedule_s": per_wave_s,
          "bit_identical_alphas": checked, "launches": {
              k: paths[k] for k in ("exp7_submit", "exp7_per_wave")}})

    upd = phase_update(drive, paths, g7, tg7, q7s)
    emit(upd)
    faults = phase_faults(drive, paths, gp, tgp)
    emit(faults)
    emit(phase_backends(drive, paths, gp, tgp))
    f32 = phase_f32(drive, paths, dict(
        gp=gp, tgp=tgp, qp=qp, grid=grid, g7=g7, tg7=tg7, q7=q7,
        period7=period7, hsv=hsv, hv=hv, ic=ic, pouts64=pouts, plan7=plan7,
        submit7_s=submit_s, timing7=timing, exp9=faults["exp9"]))
    emit(f32)
    emit(phase_service(drive, paths))

    # ---- 5. the attention entry point at published widths: all cases
    # in one path, then each output held against the plain version
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    cases = attention_cases(dev)
    case_variants = []

    def attention_path():
        outs = []
        for _, q, k, v, c in cases:
            before = dict(FA.VARIANT_LAUNCHES)
            outs.append(flash_attention(q, k, v, causal=c))
            case_variants.append({n: FA.VARIANT_LAUNCHES[n] - before[n]
                                  for n in before})
        return outs

    outs = drive("attention", attention_path)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    attn = {}
    for (name, q, k, v, causal), out, var in zip(cases, outs, case_variants):
        # each bf16 case went to the tensor-core kernel, f32 to the CUDA
        # cores
        want_var = "wgmma_bf16" if q.dtype == torch.bfloat16 else "fma_f32"
        assert var == {**dict.fromkeys(var, 0), want_var: 1}, (name, var)
        want = attention_ref(q, k, v, causal=causal)
        err = hold(f"flash_attention_kernel {name}", out, want,
                   ATTN_TOL[q.dtype])
        # the relative check: this run's reading under the limit, the
        # control's above it
        rms, ctrl = block_rel_rms(out, want), tile_drop_rms(q, k, v, causal,
                                                            want)
        if not rms <= ATTN_RMS_LIMIT[q.dtype] < ctrl:
            raise AssertionError(
                f"flash_attention_kernel {name}: block relative RMS error "
                f"{rms}, control {ctrl}, limit {ATTN_RMS_LIMIT[q.dtype]}")
        del out, want
        ms = event_ms(lambda: flash_attention(q, k, v, causal=causal), 10)
        cold_ms = cold_event_ms(
            lambda: flash_attention(q, k, v, causal=causal), 10, flush)
        plain_ms = event_ms(lambda: attention_ref(q, k, v, causal=causal), 3)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        lib_ms = event_ms(sdpa, 10)
        lib_cold_ms = cold_event_ms(sdpa, 10, flush)
        b_ms, b_by = attention_bound(q, k, v, causal)
        flops = attention_flops(q, causal)
        attn[name] = {"B": q.shape[0], "Hq": q.shape[1], "Hkv": k.shape[1],
                      "S": q.shape[2], "d": q.shape[3], "causal": causal,
                      "variant": want_var, "launches": var,
                      "max_abs_err": err, "tol": ATTN_TOL[q.dtype],
                      "block_rel_rms": rms, "tile_drop_rms": ctrl,
                      "rms_limit": ATTN_RMS_LIMIT[q.dtype], "ms": ms,
                      "cold_ms": cold_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_cold_ms": lib_cold_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                      "tflop_s": flops / ms * 1e-9,
                      "cold_tflop_s": flops / cold_ms * 1e-9,
                      "bound_share": b_ms / ms,
                      "cold_bound_share": b_ms / cold_ms}
    del outs, flush
    emit({"phase": "attention", "entry": "repro_torch.kernels."
          "flash_attention.ops.flash_attention", "cases": attn,
          "large_v": large_v_probe(dev), "launches": paths["attention"]})

    # ---- 6. the selective-scan entry point at falcon-mamba-7b width
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_per_s = sms * SFU_EXP_PER_CLOCK_PER_SM * float(smi_clock) * 1e6
    scases = scan_cases(dev)
    youts = drive("scan", lambda: [selective_scan(*a) for _, a in scases])
    scan = {}
    for (name, a), y in zip(scases, youts):
        err = hold(f"selective_scan_kernel {name}", y,
                   selective_scan_ref(*a), SCAN_TOL[a[0].dtype])
        del y
        ms = event_ms(lambda: selective_scan(*a), 10)
        plain_ms = event_ms(lambda: selective_scan_ref(*a), 1)
        b_ms, b_by = scan_bound(a, exp_per_s)
        x, _, A, _, _ = a
        scan[name] = {"B": x.shape[0], "S": x.shape[1], "Di": x.shape[2],
                      "N": A.shape[1], "max_abs_err": err,
                      "tol": SCAN_TOL[x.dtype], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by}
    del youts
    emit({"phase": "scan", "entry": "repro_torch.kernels.ssm_scan.ops."
          "selective_scan", "sm_clock_max_mhz": float(smi_clock),
          "exp_per_s": exp_per_s, "cases": scan,
          "launches": paths["scan"]})

    # ---- 7. the DSMS serving path at qwen3-8b's full size
    torch.cuda.empty_cache()
    serve = phase_serve(drive, paths)
    emit(serve)

    # ---- 8. the serving path of the moe, ssm and hybrid families
    torch.cuda.empty_cache()
    families = phase_serve_families(drive, paths)
    emit(families)

    # ---- 9. the training path at qwen2-0.5b's full size
    torch.cuda.empty_cache()
    train = phase_train(drive, paths)
    emit(train)

    # ---- 9b. the sharding path: a one-rank NCCL mesh, the dry run, 4
    # CPU ranks
    torch.cuda.empty_cache()
    emit(phase_mesh(drive, paths, train))

    # ---- 10. kernels: each path launches its own kernels and no other;
    # the kernels line carries each kernel's count on its path and, for
    # the attention and scan kernels, the numbers of the first (bf16)
    # case at the widths above
    plan_paths = ("paper_submit", "exp7_submit", "exp7_update",
                  "paper_faults", "exp9_faults", "service_on", "service_off",
                  "serve_plan", "serve_retime", "serve_fault") + tuple(
                      f"serve_{a}_{k}" for a in FAMILY_ARCHS
                      for k in ("plan", "retime", "fault"))
    for name in plan_paths + F32_PLAN_PATHS:
        assert paths[name]["sched_plan_kernel"] > 0, (name, paths[name])
        assert paths[name]["sched_wave_kernel"] == 0, (name, paths[name])
    assert paths["exp7_submit"]["sched_plan_kernel"] == 1, paths
    assert paths["f32_exp7_submit"]["sched_plan_kernel/f32"] == 1, paths
    for name in F32_WAVE_PATHS:
        assert paths[name]["sched_plan_kernel"] == 0, (name, paths[name])
        assert paths[name]["sched_wave_kernel/f32"] > 0, (name, paths)
    for name, waves in (("paper_per_wave", None), ("exp7_per_wave", W)):
        assert paths[name]["sched_plan_kernel"] == 0, (name, paths[name])
        assert paths[name]["sched_wave_kernel"] == (
            waves or paths[name]["sched_wave_kernel"]) > 0, (name, paths)
    n_bf16 = sum(q.dtype == torch.bfloat16 for _, q, _, _, _ in cases)
    for name, counts in paths.items():
        own = {"attention": {"flash_attention_kernel": len(cases),
                             "flash_attention_kernel/wgmma_bf16": n_bf16,
                             "flash_attention_kernel/fma_f32":
                                 len(cases) - n_bf16},
               "scan": {"selective_scan_kernel": len(scases)}}.get(name)
        if own is None:
            # a float64 path launches no float32 instantiation, and a
            # float32 path only those
            own = {k: counts[k] for k in K.LAUNCHES}
            if name in F32_PATHS:
                own.update({f"{k}/f32": counts[k] for k in K.LAUNCHES})
        assert counts == {**dict.fromkeys(counts, 0), **own}, (name, counts)
    src = "src/repro_torch/core/backends/csrc/sched_kernels.cu"
    a0, s0 = next(iter(attn)), next(iter(scan))
    a32 = next(n for n, c in attn.items() if c["variant"] == "fma_f32")
    emit({"kernels": [
        {"name": "sched_wave_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas.py:199",
         "path": "CompiledInstance.schedule, CudaBackend(scan=False), exp7",
         "launches": paths["exp7_per_wave"]["sched_wave_kernel"],
         "max_abs_err": max(e_w_paper, e_w7), "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "sched_plan_kernel", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas.py:396",
         "path": "Scheduler.submit, exp7; Scheduler.update and "
                 "probe_update, exp7; mark_failed, degrade and restore, "
                 "paper and exp9; SchedulerService, exp10 (coalescing on "
                 "and off); DSMSEngine.ensure_plan, retime and mark_failed, "
                 "qwen3-8b, olmoe-1b-7b, falcon-mamba-7b and zamba2-2.7b "
                 "serving graphs",
         "launches": sum(paths[k]["sched_plan_kernel"]
                         for k in plan_paths if k != "paper_submit"),
         "launches_by_path": {k: paths[k]["sched_plan_kernel"]
                              for k in plan_paths if k != "paper_submit"},
         "max_abs_err": max(e_p_paper, e_p7,
                            upd["resumed_vs_plain"]["max_abs_err"],
                            serve["plan_vs_plain"]["max_abs_err"],
                            serve["resumed_vs_plain"]["max_abs_err"],
                            *(f[k]["max_abs_err"]
                              for f in families["archs"].values()
                              for k in ("plan_vs_plain",
                                        "resumed_vs_plain"))),
         "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
        {"name": "sched_wave_kernel/f32", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas.py:199",
         "path": "CompiledInstance.schedule, CudaBackend(scan=False), "
                 "dtype=torch.float32, exp7",
         "launches": paths["f32_exp7_per_wave"]["sched_wave_kernel/f32"],
         "max_abs_err": max(f32["kernels_vs_plain"][c]["wave_max_abs_err"]
                            for c in ("paper", "exp7")),
         **{k: f32["kernel_times"]["exp7_wave"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "sched_plan_kernel/f32", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas.py:396",
         "path": "Scheduler.submit, dtype=torch.float32, paper and exp7; "
                 "mark_failed, paper; mark_failed, degrade and restore, "
                 "exp9",
         "launches": sum(paths[k]["sched_plan_kernel/f32"]
                         for k in F32_PLAN_PATHS),
         "launches_by_path": {k: paths[k]["sched_plan_kernel/f32"]
                              for k in F32_PLAN_PATHS},
         "max_abs_err": max(f32["kernels_vs_plain"][c]["plan_max_abs_err"]
                            for c in ("paper", "exp7")),
         **{k: f32["kernel_times"]["exp7_plan"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "flash_attention_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
         "path": "kernels.flash_attention.ops.flash_attention, "
                 + ", ".join(attn), "case": a0,
         "launches": paths["attention"]["flash_attention_kernel"],
         "launches_by_variant": {
             k.split("/")[1]: n for k, n in paths["attention"].items()
             if k.startswith("flash_attention_kernel/")},
         "max_abs_err": max(c["max_abs_err"] for c in attn.values()),
         **{k: attn[a0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}},
        {"name": "flash_attention_kernel/fma_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
         "path": "kernels.flash_attention.ops.flash_attention, " + a32,
         "case": a32,
         "launches": paths["attention"]["flash_attention_kernel/fma_f32"],
         **{k: attn[a32][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}},
        {"name": "selective_scan_kernel", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/kernel.py:27",
         "path": "kernels.ssm_scan.ops.selective_scan, " + ", ".join(scan),
         "case": s0, "launches": paths["scan"]["selective_scan_kernel"],
         "max_abs_err": max(c["max_abs_err"] for c in scan.values()),
         **{k: scan[s0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

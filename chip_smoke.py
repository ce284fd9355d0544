#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the scheduling kernels from ``src/repro_torch/core/backends/
csrc`` with ``nvcc``, holds each kernel against its plain PyTorch
version on the card (exact equality of every output), drives the main
path — ``Scheduler.submit`` on the paper's worked example and on the
exp7 deployment (16 ECUs, 500 tasks, the 301-alpha HVLB_CC grid in one
kernel launch) — checks the results against the pinned paper numbers
and the port's scalar reference, and prints one JSON line per phase.
The last line is ``{"ok": true, "device": {...}}``.  Any failure raises,
and the exit code is not 0; without a CUDA device it exits with 2
before printing any result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (HSV_CC, HVLB_CC_B, HVLB_CC_IC,  # noqa: E402
                              DEFAULT_BATCH_MAX, CompiledInstance,
                              CudaBackend, Scheduler, fully_switched_topology,
                              hprv_b, paper_spg, paper_topology, plan_waves,
                              priority_queue, random_spg, rank_matrix,
                              schedule_violations)
from repro_torch.core.backends import cuda as K  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

PAPER_POLICY = dict(alpha_max=3.0, period=150.0)
EXP7_POLICY = HVLB_CC_B(alpha_max=3.0, alpha_step=0.01)


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


def bound(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decision_ops(slots: int, P: int, K: int, R: int, H: int) -> int:
    """f64 operations of ``slots`` decisions: per lane, per predecessor
    route hop a max, an add and a running max, per predecessor an arrival
    max, then EST max, EFT add, A/value/B multiplies; per slot the commit's
    add, divide, multiply and add."""
    return slots * (P * (K * (3 * R * H + 1) + 5) + 4)


def check_waves(g, tg, q, alpha, period, timed_wave=None):
    """K1 on every wave of the plan: kernel vs plain on the same staged
    inputs, then the backend advances through the wave."""
    inst = CompiledInstance(g, tg, rank=rank_matrix(g, tg))
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


def check_plan(g, tg, q, alphas, period):
    """K2 on the whole plan under every alpha: kernel vs plain."""
    inst = CompiledInstance(g, tg, rank=rank_matrix(g, tg))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = K.build_library()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": str(lib.path.relative_to(ROOT)),
          "build_s": lib.build_seconds})

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

    T = pargs["T"]
    P, R, H = T.P, T.R, T.H
    Kp = pargs["pred"].shape[2]
    W, B = pargs["task"].shape
    A = len(grid)
    k1_ms = event_ms(lambda: K.sched_wave(**wargs), 50)
    k1_plain_ms = event_ms(lambda: K.wave_plain(**wargs), 3)
    k2_ms = event_ms(lambda: K.sched_plan(**pargs), 5)
    k2_plain_ms = event_ms(lambda: K.plan_plain(**pargs), 1)
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
    k1_bound, k1_by = bound(k1_bytes, decision_ops(wb, P, Kp, R, H))
    k2_bound, k2_by = bound(k2_bytes, decision_ops(A * W * B, P, Kp, R, H))
    emit({"phase": "kernel_times", "exp7_wave": {
        "B": wb, "ms": k1_ms, "plain_ms": k1_plain_ms, "bytes": k1_bytes,
        "bound_ms": k1_bound}, "exp7_plan": {
        "A": A, "W": W, "B": B, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bytes": k2_bytes, "bound_ms": k2_bound}})

    # ---- 3. main path, paper instance.  Every path is driven with the
    # launch counts set to 0 just before it and read just after it.
    paths = {}

    def drive(name, fn):
        K.reset_launches()
        result = fn()
        paths[name] = dict(K.LAUNCHES)
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
    t0 = time.perf_counter()
    plan7 = drive("exp7_submit", lambda: sched7.submit(g7, EXP7_POLICY))
    submit_s = time.perf_counter() - t0
    sess = sched7._sessions[id(g7)]       # the session's compiled state
    be7 = sess.inst.backend_instance("cuda")
    timing = dict(be7.last_timing)
    assert plan7.backend == "cuda"
    assert schedule_violations(plan7.schedule) == []
    # against the port's host reference: every grid makespan, the best
    # schedule, and the full decision traces of four more alphas
    t1 = time.perf_counter()
    ref = Scheduler(tg7, backend="scalar").submit(g7, EXP7_POLICY)
    scalar_s = time.perf_counter() - t1
    assert np.array_equal(plan7.sweep.alphas, ref.sweep.alphas)
    assert np.array_equal(plan7.sweep.makespans, ref.sweep.makespans)
    assert plan7.best_alpha == ref.best_alpha
    checked = [plan7.best_alpha, 0.0, 0.75, 1.5, 2.25]
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
          "roundtrips": be7.n_roundtrips, "state_uploads":
          be7.n_state_uploads, "scalar_sweep_s": scalar_s,
          "per_wave_schedule_s": per_wave_s,
          "bit_identical_alphas": checked, "launches": {
              k: paths[k] for k in ("exp7_submit", "exp7_per_wave")}})

    # ---- 5. kernels: each path launches its own kernel and no other;
    # the kernels line carries the exp7 paths' counts
    for name in ("paper_submit", "exp7_submit"):
        assert paths[name]["sched_plan_kernel"] > 0, (name, paths[name])
        assert paths[name]["sched_wave_kernel"] == 0, (name, paths[name])
    assert paths["exp7_submit"]["sched_plan_kernel"] == 1, paths
    for name, waves in (("paper_per_wave", None), ("exp7_per_wave", W)):
        assert paths[name]["sched_plan_kernel"] == 0, (name, paths[name])
        assert paths[name]["sched_wave_kernel"] == (
            waves or paths[name]["sched_wave_kernel"]) > 0, (name, paths)
    src = "src/repro_torch/core/backends/csrc/sched_kernels.cu"
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
         "path": "Scheduler.submit, exp7",
         "launches": paths["exp7_submit"]["sched_plan_kernel"],
         "max_abs_err": max(e_p_paper, e_p7), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

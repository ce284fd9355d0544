"""Device candidate-evaluation backend: hand-written CUDA kernels on Hopper.

Twin of ``repro.core.backends.pallas``.  The engine hands this backend
the whole level-batched wave plan of a schedule (``evaluate_plan``) or
of a whole alpha grid (``evaluate_plan_sweep``); one launch of
``sched_plan_kernel`` runs every decision of it on the card, one block
per alpha, and one fetch brings the decisions back.  The per-wave
kernel ``sched_wave_kernel`` serves single evaluations (``evaluate``),
``evaluate_batch`` and the per-wave plan path (``scan=False``): one
launch and one fetch per wave.  Both kernels live in
``csrc/sched_kernels.cu`` and share one ``__device__`` decision
routine.

Each kernel has a **plain PyTorch version** here (:func:`wave_plain`,
:func:`plan_plain`) with the same algebra, one torch op per IEEE
rounding step, over an explicit ``(A,)`` alpha axis.  Both return the
kernels' outputs: the A / B coefficients of every candidate lane (the
crossing bounds read them) and everything else of the winner lane
only (:class:`PlanOut`).  The wrappers
(:func:`sched_wave`, :func:`sched_plan`) take the plain version only for
tensors that lie on the CPU; for CUDA tensors they launch the kernel or
raise.  :data:`LAUNCHES` counts kernel launches per kernel.

Numerics come in two real types, chosen per backend (``dtype``; the
reference picks one per process with ``REPRO_PALLAS_DTYPE``):

  * **float64** (the default): bit-identical to the scalar reference.
  * **float32**: the reference's TPU numerics.  Decisions equal the f64
    scalar reference's except where two candidates' selection values, or
    two routes' LFTs, differ by less than :data:`F32_NEAR_TIE_RTOL`
    (relative); there the winner is the f32-lexicographic ``(value,
    EFT, proc)`` argmin, first index on exact f32 ties.  The tables, the
    state carry, the alphas, the period and the carried AFTs are rounded
    to float32 where they are staged (as the reference casts them); the
    host mirrors stay float64, committed from the decoded float32
    values by the shared ``apply``.  Predecessors are ordered by their
    AFTs rounded to float32, the key the plan kernel sorts by on the
    card, in staging and in decoding alike.

In both the kernels are built with ``--fmad=false`` and round every step
explicitly (``__dadd_rn``/``__dmul_rn``/``__ddiv_rn`` in f64,
``__fadd_rn``/``__fmul_rn``/``__fdiv_rn`` in f32); the plain versions
take their dtype from the tables and the state, never fuse a multiply
and an add, and divide by a device tensor (a CPU-scalar divisor would
let PyTorch multiply by its reciprocal on the card).  :data:`LAUNCHES`
counts every launch of each kernel, and :data:`F32_LAUNCHES` those of
its float32 instantiation (``sched_wave_kernel/f32`` and
``sched_plan_kernel/f32`` in a run's report), as the attention kernel
counts its variants.

Where the reference buckets shapes to powers of two, tile-pads them and
keeps a bounded cache of compiled kernels, these kernels take their
sizes at run time: W, B, K and A are passed exactly.  The host picks
each launch's shared-memory layout (:func:`launch_layout`): how many
slots a wave stages at once, and whether the carried AFT / placement
rows live on chip.  The library is
built by :func:`repro_torch._nvcc.build` from the package's sources at
first use into ``build/repro_torch/`` of the checkout, keyed by a hash
of the source and flags, and loaded with ``ctypes``.

Host side, method by method: ``_run_batch`` stages, launches and decodes
one wave as the reference's does; :meth:`CudaBackend.stage_plan` and
:meth:`CudaBackend.tables` are ``_scan_inputs`` and ``_scan_tables``;
``_plan_dispatch`` and ``_decode_plan`` are ``_scan_dispatch`` and
``_decode_scan``.

``n_launches`` / ``n_roundtrips`` / ``n_state_uploads`` count dispatches
(kernel or plain), blocking device->host fetches and host->device state
uploads, as in the reference; ``last_timing`` splits the last plan or
sweep dispatch into staging, kernel, fetch and decode seconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _nvcc
from ..._nvcc import on_cuda as _on_cuda, raise_on as _raise_on
from ..faults import WaveTimeoutError
from .base import CandidateEvaluator, Decision
from .layout import src_layout, stacked_edge_ct, stacked_src_tensors

__all__ = ["CudaBackend", "DTYPES", "F32_LAUNCHES", "F32_NEAR_TIE_RTOL",
           "LAUNCHES", "Layout", "PlanOut", "ROWS_SMEM_MAX", "RouteTables",
           "build_library", "check_device", "check_dtype", "crossings",
           "launch_layout", "plan_plain", "reset_launches", "sched_plan",
           "sched_wave", "wave_plain"]

_INF = float("inf")
_NEG_INF = float("-inf")

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_kernels.cu"
# bit-exact decisions: no multiply-add is ever fused
NVCC_FLAGS = _nvcc.BASE_FLAGS + ("--fmad=false",)

# limits the wrappers check before a launch: candidate lanes (one
# thread per processor up to SCHED_MAX_THREADS = 512, two past it) and
# Hopper's shared memory per block
_MAX_LANES = 1024
_MAX_SMEM = 232448
# the plan kernel keeps the carried AFT / placement rows in shared memory
# while the block's total stays within 48 KB, the size a block takes
# without opting in: four such blocks share an SM, so a grid of up to
# 4 x 132 alphas (the exp7 grid has 301) stays resident in one round
ROWS_SMEM_MAX = 48 * 1024

# The float32 mode's near-tie band (the reference's constant): two
# candidates whose selection values, or two routes whose LFTs, agree
# within this relative tolerance may resolve differently from the f64
# scalar reference.  It documents the tests; no decision reads it.
F32_NEAR_TIE_RTOL = 1e-5

# the real types of the kernels: float64 (the default) and float32
DTYPES = (torch.float64, torch.float32)

# kernel launches per kernel, either real type, and of the float32
# instantiations alone (plain-version calls are not counted)
LAUNCHES: Dict[str, int] = {"sched_wave_kernel": 0, "sched_plan_kernel": 0}
F32_LAUNCHES: Dict[str, int] = {"sched_wave_kernel": 0,
                                "sched_plan_kernel": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _count(kernel: str, dtype: torch.dtype) -> None:
    if dtype == torch.float64:
        _nvcc.count_launch((LAUNCHES, kernel))
    else:
        _nvcc.count_launch((LAUNCHES, kernel), (F32_LAUNCHES, kernel))


def check_device(device) -> torch.device:
    """The device the backend runs on: ``"cuda"`` (the kernels) or
    ``"cpu"`` (their plain versions).  Raises on a host without CUDA
    when the card was not declined — nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the cuda backend runs its kernels on the card; "
            "pass device='cpu' for their plain PyTorch versions or "
            "backend='scalar' for the host reference")
    return dev


def check_dtype(dtype) -> torch.dtype:
    """The backend's real type: ``torch.float64`` (the default, also for
    ``None``) or ``torch.float32`` (the near-tie mode).  Anything else
    raises ``ValueError``, as the reference's ``REPRO_PALLAS_DTYPE=bf16``
    does."""
    if dtype is None:
        return torch.float64
    if not isinstance(dtype, torch.dtype) or dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                         f"got {dtype!r}")
    return dtype


# ----------------------------------------------------------------------
# The library
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Library:
    built: _nvcc.Library

    @property
    def lib(self) -> ctypes.CDLL:
        return self.built.lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float


def _load() -> _Library:
    built = _nvcc.build("sched_kernels", [SOURCE], NVCC_FLAGS)
    lib = built.lib
    lib.sched_smem.argtypes = [_I] * 8
    lib.sched_smem.restype = ctypes.c_size_t
    lib.sched_wave_launch.argtypes = (
        [_P] * 12 + [_D, _D] + [_P] * 18 + [_I] * 7 + [_P])
    lib.sched_wave_launch.restype = _I
    lib.sched_plan_launch.argtypes = (
        [_P] * 13 + [_D] + [_P] * 22 + [_I] * 12 + [_P])
    lib.sched_plan_launch.restype = _I
    lib.sched_wave_launch_f32.argtypes = (
        [_P] * 12 + [_F, _F] + [_P] * 18 + [_I] * 7 + [_P])
    lib.sched_wave_launch_f32.restype = _I
    lib.sched_plan_launch_f32.argtypes = (
        [_P] * 13 + [_F] + [_P] * 22 + [_I] * 12 + [_P])
    lib.sched_plan_launch_f32.restype = _I
    return _Library(built)


_LIB = _nvcc.LibraryCache(_load)


def build_library() -> _Library:
    """Build (once per source hash) and load the kernels' shared library,
    the same handle for every thread.

    Raises :class:`~repro_torch._nvcc.KernelError` when ``nvcc`` is
    missing or the build fails.
    """
    return _LIB.get()


# ----------------------------------------------------------------------
# Inputs and outputs
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RouteTables:
    """Device-resident instance tables the kernels gather from (see
    ``csrc/sched_kernels.cu`` and :mod:`.layout` for the layout)."""

    lid: torch.Tensor       # (P+1, R, H, P) int32, -1 = no link
    valid: torch.Tensor     # (P+1, R, P) int32
    nhops: torch.Tensor     # (P+1, R, P) int32
    ct: torch.Tensor        # (E+1, P+1, R, H, P) real
    comp: torch.Tensor      # (n, P) real
    ldet: torch.Tensor      # (n, P) real, exit rows 1.0
    n_links: int

    @property
    def dtype(self) -> torch.dtype:
        """The kernels' real type: float64 or float32."""
        return self.comp.dtype

    @property
    def P(self) -> int:
        return self.comp.shape[1]

    @property
    def R(self) -> int:
        return self.lid.shape[1]

    @property
    def H(self) -> int:
        return self.lid.shape[2]

    @property
    def E(self) -> int:
        return self.ct.shape[0] - 1

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.lid, self.valid, self.nhops, self.ct, self.comp,
                self.ldet)


@dataclasses.dataclass
class PlanOut:
    """Per-decision outputs of either kernel, leading dims ``(...)`` =
    ``(B,)`` for a wave or ``(A, W, B)`` for a plan: the winner lane's,
    and the coefficients of every lane."""

    win: torch.Tensor       # (...) int32 winner lane
    est: torch.Tensor       # (...)
    eft: torch.Tensor       # (...)
    ca: torch.Tensor        # (..., P)  A_p = EFT * LDET
    cb: torch.Tensor        # (..., P)  B_p = A_p * loads/period
    lst: torch.Tensor       # (..., K, H) selected-route hop LSTs
    lft: torch.Tensor       # (..., K, H) selected-route hop LFTs
    route: torch.Tensor     # (..., K) int32 selected route

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.win, self.est, self.eft, self.ca, self.cb, self.lst,
                self.lft, self.route)


# (link_free (L), proc_free, loads, loads/period, BP (P)), with a leading
# (A,) axis on plan outputs
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def _check(t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...],
           what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


@dataclasses.dataclass(frozen=True)
class Layout:
    """One launch's shared-memory layout (``sched_layout`` in the
    source): ``chunk`` slots of a wave staged at once, the carried AFT /
    placement rows on chip (``rows`` = n) or not (0), and the block's
    bytes."""

    chunk: int
    rows: int
    smem: int


def launch_layout(T: RouteTables, K: int, B: int, n: int = 0) -> Layout:
    """The layout of a launch of ``B``-slot waves with ``K`` predecessor
    slots (``n`` carried rows for the plan kernel, 0 for the wave
    kernel): the decision state and scratch, as large a chunk of staged
    slots as fits (up to ``B``), and the carried rows if the total stays
    within :data:`ROWS_SMEM_MAX`.  Raises when one slot does not fit or
    ``P`` exceeds the kernels' 1024 candidate lanes."""
    P, L, R, H = T.P, T.n_links, T.R, T.H
    if P > _MAX_LANES:
        raise ValueError(f"{P} processors exceed the kernels' "
                         f"{_MAX_LANES} candidate lanes")
    lib = build_library()

    real = T.comp.element_size()

    def smem(chunk: int, rows: int) -> int:
        return int(lib.lib.sched_smem(P, L, K, R, H, chunk, rows, real))

    if smem(1, 0) > _MAX_SMEM:
        raise ValueError(f"{smem(1, 0)} bytes of shared memory exceed "
                         f"Hopper's {_MAX_SMEM} per block")
    base = smem(0, 0)                  # the layout is affine in the chunk
    chunk = min(B, (_MAX_SMEM - base) // (smem(1, 0) - base))
    rows = n if n and smem(chunk, n) <= ROWS_SMEM_MAX else 0
    return Layout(chunk, rows, smem(chunk, rows))


def _check_tables(T: RouteTables) -> torch.dtype:
    """Checks the tables and returns their real type."""
    P, R, H, E = T.P, T.R, T.H, T.E
    n = T.comp.shape[0]
    f = T.dtype
    if f not in DTYPES:
        raise ValueError(f"tables: expected float64 or float32, got {f}")
    _check(T.lid, torch.int32, (P + 1, R, H, P), "lid")
    _check(T.valid, torch.int32, (P + 1, R, P), "valid")
    _check(T.nhops, torch.int32, (P + 1, R, P), "nhops")
    _check(T.ct, f, (E + 1, P + 1, R, H, P), "ct")
    _check(T.comp, f, (n, P), "comp")
    _check(T.ldet, f, (n, P), "ldet")
    return f


# ----------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------
def _decide_plain(T: RouteTables, j: int, is_exit: bool, is_real: bool,
                  s_aft: torch.Tensor, s_src: torch.Tensor,
                  s_edge: torch.Tensor, alpha: torch.Tensor,
                  period: torch.Tensor, state: State
                  ) -> Tuple[Tuple[torch.Tensor, ...], State]:
    """One decision for every alpha: the algebra of the kernels'
    ``decide`` over an ``(A,)`` axis (sorted predecessor triples
    ``s_*`` ``(A, K)``, ``alpha`` ``(A, 1)``, ``period`` ``(A, P)``).
    Returns every lane's values (``est``/``eft`` ``(A, P)``,
    ``lst``/``lft`` ``(A, K, H, P)``, ``route`` ``(A, K, P)``);
    :func:`_at_winner` reduces them to the kernels' outputs."""
    lf, pf, loads, lop, bp = state
    A, L = lf.shape
    P, R, H = T.P, T.R, T.H
    K = s_aft.shape[1]
    # lane buffer with two extra link columns: L reads -inf, L+1 is the
    # write sink for hops without a link
    lane = torch.cat([lf[:, None, :].expand(A, P, L),
                      lf.new_full((A, P, 2), _NEG_INF)], dim=2).contiguous()
    arrival = lf.new_full((A, P), _NEG_INF)
    lst_o = lf.new_empty((A, K, H, P))
    lft_o = lf.new_empty((A, K, H, P))
    route_o = torch.empty((A, K, P), dtype=torch.int32, device=lf.device)
    for k in range(K):
        src = s_src[:, k].long()
        lid = T.lid[src].long()                          # (A, R, H, P)
        valid = T.valid[src] > 0                         # (A, R, P)
        nh = T.nhops[src]                                # (A, R, P)
        ct = T.ct[s_edge[:, k].long(), src]              # (A, R, H, P)
        rd = torch.where(lid < 0, L, lid)
        wr = torch.where(lid < 0, L + 1, lid)
        aft_i = s_aft[:, k:k + 1]
        r_lst: List[List[torch.Tensor]] = []
        r_lft: List[List[torch.Tensor]] = []
        r_final: List[torch.Tensor] = []
        for r in range(R):
            lsts: List[torch.Tensor] = []
            lfts: List[torch.Tensor] = []
            for h in range(H):
                avail = lane.gather(2, rd[:, r, h, :, None])[..., 0]
                lst = torch.maximum(avail, aft_i) if h == 0 \
                    else torch.maximum(lst, avail)               # Eq. 13
                x = lst + ct[:, r, h]
                lft = x if h == 0 else torch.maximum(lft, x)     # Eq. 14
                lsts.append(lst)
                lfts.append(lft)
            r_lst.append(lsts)
            r_lft.append(lfts)
            r_final.append(torch.where(valid[:, r], lft, _INF))
        # lexicographic (LFT, hops, route index) pick per lane
        best_f = r_final[0]
        best_nh = nh[:, 0]
        best_r = torch.zeros((A, P), dtype=torch.int64, device=lf.device)
        for r in range(1, R):
            fv = r_final[r]
            better = (fv < best_f) | ((fv == best_f) & (nh[:, r] < best_nh))
            best_f = torch.where(better, fv, best_f)
            best_nh = torch.where(better, nh[:, r], best_nh)
            best_r = torch.where(better, r, best_r)
        for h in range(H):
            sel_lst = r_lst[0][h]
            sel_lft = r_lft[0][h]
            sel_wr = wr[:, 0, h]
            for r in range(1, R):
                pick = best_r == r
                sel_lst = torch.where(pick, r_lst[r][h], sel_lst)
                sel_lft = torch.where(pick, r_lft[r][h], sel_lft)
                sel_wr = torch.where(pick, wr[:, r, h], sel_wr)
            lst_o[:, k, h] = sel_lst
            lft_o[:, k, h] = sel_lft
            # LFT >= avail, so an overwrite is the scalar "write if greater"
            lane.scatter_(2, sel_wr[..., None], sel_lft[..., None])
        route_o[:, k] = best_r
        arrival = torch.maximum(arrival, best_f)

    comp_j = T.comp[j]
    est = torch.maximum(arrival, pf)                             # Eqs. 10-11
    eft = est + comp_j                                           # Eq. 12
    a = eft * T.ldet[j]
    value = a * (torch.ones_like(bp) if is_exit else bp)         # Def. 4.2
    cb = a * lop
    # strict lexicographic (value, EFT, proc) argmin, first index on ties
    idx = torch.arange(P, device=lf.device)
    tie = value == value.amin(-1, keepdim=True)
    emin = torch.where(tie, eft, _INF).amin(-1, keepdim=True)
    tie &= eft == emin
    w = torch.where(tie, idx, P).amin(-1)                        # (A,)
    if is_real:
        onehot = idx[None, :] == w[:, None]
        lf = lane[torch.arange(A, device=lf.device), w, :L]
        pf = torch.where(onehot, eft, pf)
        loads = torch.where(onehot, loads + comp_j, loads)
        lop = torch.where(onehot, loads / period, lop)
        bp = torch.where(onehot, 1.0 + lop * alpha, bp)          # Def. 4.1
    outs = (w.to(torch.int32), est, eft, a, cb, lst_o, lft_o, route_o)
    return outs, (lf, pf, loads, lop, bp)


def _at_winner(outs: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """A decision's outputs as the kernels write them: ``est``, ``eft``,
    ``lst``, ``lft`` and ``route`` taken at the winner lane, ``ca`` and
    ``cb`` for every lane."""
    w, est, eft, ca, cb, lst, lft, route = outs
    wl = w.long()

    def at(x: torch.Tensor) -> torch.Tensor:
        idx = wl.view(-1, *([1] * (x.dim() - 1)))
        return x.gather(-1, idx.expand(*x.shape[:-1], 1))[..., 0]

    return (w, at(est), at(eft), ca, cb, at(lst), at(lft), at(route))


def wave_plain(T: RouteTables, task: torch.Tensor, real: torch.Tensor,
               exitf: torch.Tensor, paft: torch.Tensor, psrc: torch.Tensor,
               pedge: torch.Tensor, alpha: float, period: float,
               state: State) -> Tuple[PlanOut, State]:
    """Plain version of ``sched_wave_kernel``: one wave of ``B``
    decisions in order, predecessors pre-sorted by the host into
    ``paft``/``psrc``/``pedge`` ``(B, K)``."""
    B, K = paft.shape
    P = T.P
    dev = paft.device
    st = tuple(s[None] for s in state)
    alpha_t = torch.full((1, 1), alpha, dtype=T.dtype, device=dev)
    period_t = torch.full((1, P), period, dtype=T.dtype, device=dev)
    cols: List[Tuple[torch.Tensor, ...]] = []
    # analysis: allow[host-sync] the plain version runs on the CPU only: no device to wait for
    task_l, real_l, exit_l = task.tolist(), real.tolist(), exitf.tolist()
    for b, (j, r, x) in enumerate(zip(task_l, real_l, exit_l)):
        outs, st = _decide_plain(T, j, bool(x), bool(r), paft[b:b + 1],
                                 psrc[b:b + 1], pedge[b:b + 1], alpha_t,
                                 period_t, st)
        cols.append(_at_winner(outs))
    stacked = [torch.cat(c) for c in zip(*cols)]
    return PlanOut(*stacked), tuple(s[0] for s in st)


def plan_plain(T: RouteTables, task: torch.Tensor, real: torch.Tensor,
               exitf: torch.Tensor, pred: torch.Tensor, pvalid: torch.Tensor,
               pedge: torch.Tensor, alphas: torch.Tensor, period: float,
               state: State, aft0: torch.Tensor, proc0: torch.Tensor
               ) -> Tuple[PlanOut, State, torch.Tensor, torch.Tensor]:
    """Plain version of ``sched_plan_kernel``: the ``W x B`` plan for
    every alpha, predecessors sorted by the carried ``(aft, id)`` key.
    Returns the decisions ``(A, W, B, ...)``, the final state ``(A, ...)``
    and the final per-alpha AFT / placement rows ``(A, n)``."""
    W, B = task.shape
    K = pred.shape[2]
    A = alphas.shape[0]
    P, E = T.P, T.E
    n = aft0.shape[0]
    dev = alphas.device
    st = tuple(s[None].expand(A, *s.shape).clone() for s in state)
    aft = aft0[None].expand(A, n).clone()
    proc = proc0[None].expand(A, n).clone()
    alpha_t = alphas[:, None]
    period_t = torch.full((A, P), period, dtype=T.dtype, device=dev)
    out = _empty_out((A, W, B), K, T, dev)
    # analysis: allow[host-sync] the plain version runs on the CPU only: no device to wait for
    task_l, real_l, exit_l = task.tolist(), real.tolist(), exitf.tolist()
    for wv in range(W):
        for b in range(B):
            pv = pvalid[wv, b] > 0                               # (K,)
            pr = pred[wv, b].long()
            paft = torch.where(pv, aft[:, pr], _INF)             # (A, K)
            pkey = torch.where(pv, pr, n).expand(A, K)
            # lexsort by (aft, id): stable by id, then stable by aft
            o1 = torch.sort(pkey, dim=1, stable=True).indices
            o2 = torch.sort(paft.gather(1, o1), dim=1, stable=True).indices
            perm = o1.gather(1, o2)
            sp = pr[perm]
            spv = pv[perm]
            s_aft = torch.where(spv, aft.gather(1, sp), _NEG_INF)
            s_src = torch.where(spv, proc.gather(1, sp), P)
            s_edge = torch.where(spv, pedge[wv, b].long()[perm], E)
            j = task_l[wv][b]
            is_real = bool(real_l[wv][b])
            outs, st = _decide_plain(T, j, bool(exit_l[wv][b]), is_real,
                                     s_aft, s_src, s_edge, alpha_t, period_t,
                                     st)
            outs = _at_winner(outs)
            for dst, src in zip(out.tensors(), outs):
                dst[:, wv, b] = src
            if is_real:
                aft[:, j] = outs[2]
                proc[:, j] = outs[0]
    return out, st, aft, proc


def _empty_out(lead: Tuple[int, ...], K: int, T: RouteTables,
               dev: torch.device) -> PlanOut:
    P, H = T.P, T.H
    f = dict(dtype=T.dtype, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    return PlanOut(torch.empty(lead, **i), torch.empty(lead, **f),
                   torch.empty(lead, **f), torch.empty(lead + (P,), **f),
                   torch.empty(lead + (P,), **f),
                   torch.empty(lead + (K, H), **f),
                   torch.empty(lead + (K, H), **f),
                   torch.empty(lead + (K,), **i))


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors
# ----------------------------------------------------------------------
def sched_wave(T: RouteTables, task: torch.Tensor, real: torch.Tensor,
               exitf: torch.Tensor, paft: torch.Tensor, psrc: torch.Tensor,
               pedge: torch.Tensor, alpha: float, period: float,
               state: State) -> Tuple[PlanOut, State]:
    """One wave of decisions (``sched_wave_kernel``); returns the
    decisions and the state after the wave's commits (new tensors:
    ``state`` is left as it was)."""
    if paft.shape[0] == 0:
        raise ValueError("a wave needs at least one decision slot")
    tensors = (*T.tensors(), task, real, exitf, paft, psrc, pedge, *state)
    if not _on_cuda(tensors):
        return wave_plain(T, task, real, exitf, paft, psrc, pedge, alpha,
                          period, state)
    lib = build_library()
    B, K = paft.shape
    P, L = T.P, T.n_links
    f = _check_tables(T)
    for t, dt, shp, what in ((task, torch.int32, (B,), "task"),
                             (real, torch.int32, (B,), "real"),
                             (exitf, torch.int32, (B,), "exitf"),
                             (paft, f, (B, K), "paft"),
                             (psrc, torch.int32, (B, K), "psrc"),
                             (pedge, torch.int32, (B, K), "pedge"),
                             (state[0], f, (L,), "link_free")):
        _check(t, dt, shp, what)
    for s in state[1:]:
        _check(s, f, (P,), "processor state")
    lay = launch_layout(T, K, B)
    st = tuple(torch.empty_like(s) for s in state)
    out = _empty_out((B,), K, T, paft.device)
    launch = lib.lib.sched_wave_launch if f == torch.float64 \
        else lib.lib.sched_wave_launch_f32
    with torch.cuda.device(paft.device):
        stream = torch.cuda.current_stream(paft.device).cuda_stream
        rc = launch(
            *(t.data_ptr() for t in T.tensors()),
            *(t.data_ptr() for t in (task, real, exitf, paft, psrc, pedge)),
            float(alpha), float(period),
            *(t.data_ptr() for t in state + st + out.tensors()),
            B, K, T.R, T.H, P, L, lay.chunk, stream)
    _raise_on(rc, "sched_wave_kernel")
    _count("sched_wave_kernel", f)
    return out, st


def sched_plan(T: RouteTables, task: torch.Tensor, real: torch.Tensor,
               exitf: torch.Tensor, pred: torch.Tensor, pvalid: torch.Tensor,
               pedge: torch.Tensor, alphas: torch.Tensor, period: float,
               state: State, aft0: torch.Tensor, proc0: torch.Tensor
               ) -> Tuple[PlanOut, State, torch.Tensor, torch.Tensor]:
    """The whole ``W x B`` plan under every alpha (``sched_plan_kernel``,
    one block per alpha); see :func:`plan_plain` for the outputs."""
    if alphas.shape[0] == 0 or task.numel() == 0:
        raise ValueError("a plan needs at least one alpha and one slot")
    tensors = (*T.tensors(), task, real, exitf, pred, pvalid, pedge, alphas,
               *state, aft0, proc0)
    if not _on_cuda(tensors):
        return plan_plain(T, task, real, exitf, pred, pvalid, pedge, alphas,
                          period, state, aft0, proc0)
    lib = build_library()
    W, B = task.shape
    K = pred.shape[2]
    A = alphas.shape[0]
    P, L = T.P, T.n_links
    n = aft0.shape[0]
    f = _check_tables(T)
    for t, dt, shp, what in ((task, torch.int32, (W, B), "task"),
                             (real, torch.int32, (W, B), "real"),
                             (exitf, torch.int32, (W, B), "exitf"),
                             (pred, torch.int32, (W, B, K), "pred"),
                             (pvalid, torch.int32, (W, B, K), "pvalid"),
                             (pedge, torch.int32, (W, B, K), "pedge"),
                             (alphas, f, (A,), "alphas"),
                             (state[0], f, (L,), "link_free"),
                             (aft0, f, (n,), "aft0"),
                             (proc0, torch.int32, (n,), "proc0")):
        _check(t, dt, shp, what)
    for s in state[1:]:
        _check(s, f, (P,), "processor state")
    if T.comp.shape[0] != n:
        raise ValueError(f"aft0 has {n} tasks, comp {T.comp.shape[0]}")
    lay = launch_layout(T, K, B, n)
    dev = alphas.device
    fd = dict(dtype=f, device=dev)
    out = _empty_out((A, W, B), K, T, dev)
    aft = torch.empty((A, n), **fd)
    proc = torch.empty((A, n), dtype=torch.int32, device=dev)
    st = (torch.empty((A, L), **fd),) + tuple(torch.empty((A, P), **fd)
                                             for _ in range(4))
    launch = lib.lib.sched_plan_launch if f == torch.float64 \
        else lib.lib.sched_plan_launch_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            *(t.data_ptr() for t in T.tensors()),
            *(t.data_ptr() for t in (task, real, exitf, pred, pvalid, pedge,
                                     alphas)),
            float(period),
            *(t.data_ptr() for t in state + (aft0, proc0, aft, proc)
              + out.tensors() + st),
            A, W, B, K, T.R, T.H, P, L, n, T.E, lay.chunk, lay.rows,
            stream)
    _raise_on(rc, "sched_plan_kernel")
    _count("sched_plan_kernel", f)
    return out, st, aft, proc


def crossings(win: np.ndarray, ca: np.ndarray, cb: np.ndarray,
              alpha: float) -> np.ndarray:
    """:meth:`CandidateEvaluator.crossing` for every decision at once:
    winner lanes ``win`` ``(...)``, coefficients ``ca``/``cb``
    ``(..., P)``.  The same IEEE operations elementwise, and a min over
    the rivals in place of the running min (exact), so each bound is the
    scalar method's float.  The coefficients are read in float64 (a
    float32 plan's too, as the reference's host reads them)."""
    ca = np.asarray(ca, dtype=np.float64)
    cb = np.asarray(cb, dtype=np.float64)
    p = win.astype(np.int64)[..., None]
    a_c = np.take_along_axis(ca, p, -1)
    b_c = np.take_along_axis(cb, p, -1)
    d_b = b_c - cb
    d_a = ca - a_c
    scale = np.abs(a_c) + np.abs(ca) + 1.0
    tol = 1e-15 * scale
    cross = d_b > tol
    tie = ~cross & (np.abs(d_b) <= tol) & (np.abs(d_a) <= 1e-12 * scale)
    with np.errstate(divide="ignore", invalid="ignore"):
        a_star = d_a / d_b
    cand = np.where(cross, a_star, np.where(tie, alpha, _INF))
    np.put_along_axis(cand, p, _INF, -1)          # the winner is no rival
    return cand.min(-1, initial=_INF)


def _fetch(out: PlanOut) -> Tuple[np.ndarray, ...]:
    """Fetch the decisions to the host: ``(win, est, eft, ca, cb, lst,
    lft, route)`` as the kernels wrote them."""
    # analysis: allow[host-sync] the documented one fetch per dispatch: every decision of the wave or plan decodes from it
    return tuple(t.cpu().numpy() for t in out.tensors())


# ----------------------------------------------------------------------
# The backend
# ----------------------------------------------------------------------
class CudaBackend(CandidateEvaluator):
    """Device candidate evaluation: one kernel launch per plan or sweep
    (``scan=True``, the default) or per wave (``scan=False``), in the
    instance's real type unless ``dtype`` is given (``torch.float64`` or
    ``torch.float32``, the near-tie mode)."""

    name = "cuda"

    def __init__(self, inst, device=None, scan: bool = True,
                 dtype=None) -> None:
        super().__init__(inst)
        self.device = check_device(inst.device if device is None
                                   else device)
        self.dtype = check_dtype(inst.dtype if dtype is None else dtype)
        self.scan = scan
        P = inst.P
        self._L = max(1, inst._n_links)
        lays = [src_layout(inst, s) for s in range(P)]
        self._R = max(lay.R for lay in lays)
        self._H = max(lay.H for lay in lays)
        self._K = max([1] + [len(p) for p in inst._preds])
        self._E = len(inst._edge_index)
        self._tables: Optional[RouteTables] = None
        self.n_launches = 0
        self.n_roundtrips = 0
        self.n_state_uploads = 0
        self.last_timing: Dict[str, float] = {}

    # ------------------------------------------------------------ device
    def tables(self) -> RouteTables:
        """The instance's route/CTML/comp/LDET tables on the device
        (built and uploaded once per backend)."""
        if self._tables is None:
            inst = self.inst
            lid, valid, nhops = stacked_src_tensors(inst, self._R, self._H)
            ct = stacked_edge_ct(inst, self._R, self._H)
            ldet = np.array(inst.ldet, dtype=np.float64)
            ldet[inst._is_exit, :] = 1.0
            self._tables = RouteTables(
                *(self._dev(x) for x in (lid, valid, nhops)),
                *(self._real(x) for x in (ct, inst.comp, ldet)),
                n_links=self._L)
        return self._tables

    def _dev(self, arr) -> torch.Tensor:
        # a private contiguous copy: staged arrays may be read-only views
        return torch.from_numpy(np.array(arr, order="C")).to(self.device)

    def _real(self, arr) -> torch.Tensor:
        """A float64 host array staged in the kernels' real type (rounded
        to nearest on the host, as the reference casts it)."""
        t = torch.from_numpy(np.array(arr, dtype=np.float64, order="C"))
        return t.to(self.dtype).to(self.device)

    # ------------------------------------------------------------- state
    def _alloc(self) -> None:
        P, L = self.inst.P, self._L
        self.link_free = np.zeros(L, dtype=np.float64)       # host mirror
        self.proc_free = np.zeros(P, dtype=np.float64)
        self.loads = np.zeros(P, dtype=np.float64)
        self._lop = np.zeros(P, dtype=np.float64)
        self._bp = np.ones(P, dtype=np.float64)
        # device state carry of the per-wave path, rebuilt from the host
        # mirrors on first use and after any host-side commit
        self._state: Optional[State] = None
        self._state_dirty = True

    def _state_from_mirrors(self) -> State:
        self.n_state_uploads += 1
        return tuple(self._real(x) for x in (self.link_free, self.proc_free,
                                             self.loads, self._lop,
                                             self._bp))

    def _commit_host(self, j: int, p: int, est: float, eft: float,
                     msgs: list) -> None:
        """Mirror one device commit on the host: the shared scalar
        ``apply`` plus the Def.-4.1 terms, same floats in the same
        order as any other backend."""
        CandidateEvaluator.apply(self, j, p, est, eft, msgs)
        lop = self.loads[p] / self.period
        self._lop[p] = lop
        self._bp[p] = 1.0 + lop * self.alpha

    def apply(self, j: int, p: int, est: float, eft: float,
              msgs: list) -> None:
        """Trace-replay commit: host mirrors only; the device carry is
        rebuilt before the next launch."""
        self._commit_host(j, p, est, eft, msgs)
        self._state_dirty = True

    # ------------------------------------------------------------ decode
    def _decision(self, j: int, p: int, preds: Sequence[int],
                  srcs: Sequence[int], est: float, eft: float,
                  ca_row: list, cb_row: list, lst: list, lft: list,
                  route: list, contrib: float, want_bound: bool
                  ) -> Decision:
        inst = self.inst
        msgs = []
        for k, (i, src) in enumerate(zip(preds, srcs)):
            if src == p:
                continue
            lids, robj = inst._src_layouts[src].route_meta[p][route[k]]
            msgs.append((i, robj, [(lids[h], lst[k][h], lft[k][h])
                                   for h in range(len(lids))]))
        if want_bound and not inst._is_exit[j]:
            ca, cb = tuple(ca_row), tuple(cb_row)
        else:
            ca = cb = None
            contrib = _INF
        return (p, est, eft, msgs, ca, cb, contrib)

    def _sort_keys(self, aft: List[float]) -> List[float]:
        """The AFTs as the plan kernel holds and sorts them: ``aft``
        itself in float64, a copy rounded to float32 in float32 (two
        float64 AFTs of a replayed prefix may round to one float32, and
        then the id decides)."""
        if self.dtype == torch.float64:
            return aft
        # analysis: allow[host-sync] a host list rounded on the host; no tensor
        return np.asarray(aft, dtype=np.float32).astype(np.float64).tolist()

    def _sorted_preds(self, j: int, key: Sequence[float]) -> List[int]:
        """``j``'s predecessors in the kernels' ``(aft, id)`` order, the
        AFTs read from ``key`` (:meth:`_sort_keys`)."""
        preds = self.inst._preds[j]
        if len(preds) > 1:
            preds = sorted(preds, key=lambda i: (key[i], i))
        return preds

    # ---------------------------------------------------- per-wave path
    def stage_wave(self, js: Sequence[int], commit: bool) -> dict:
        """The kernel arguments of one wave (:func:`sched_wave`), with
        predecessors sorted by the host's ``(aft, id)`` mirrors."""
        inst = self.inst
        P, K, E = inst.P, self._K, self._E
        B = len(js)
        task = np.asarray(js, dtype=np.int32).reshape(B)
        real = np.full(B, 1 if commit else 0, dtype=np.int32)
        exitf = np.array([inst._is_exit[j] for j in js],
                         dtype=np.int32).reshape(B)
        paft = np.full((B, K), _NEG_INF)
        psrc = np.full((B, K), P, dtype=np.int32)
        pedge = np.full((B, K), E, dtype=np.int32)
        eidx = inst._edge_index
        key = self._sort_keys(self.aft)
        for b, j in enumerate(js):
            for k, i in enumerate(self._sorted_preds(j, key)):
                paft[b, k] = self.aft[i]
                psrc[b, k] = self.proc_of[i]
                pedge[b, k] = eidx[(i, j)]
        if self._state_dirty:
            self._state = self._state_from_mirrors()
            self._state_dirty = False
        return dict(T=self.tables(), task=self._dev(task),
                    real=self._dev(real), exitf=self._dev(exitf),
                    paft=self._real(paft), psrc=self._dev(psrc),
                    pedge=self._dev(pedge), alpha=self.alpha,
                    period=self.period, state=self._state)

    def _run_batch(self, js: Sequence[int], commit: bool) -> List[Decision]:
        """Stage one wave, launch one kernel, decode one fetch."""
        args = self.stage_wave(js, commit)
        out, state = sched_wave(**args)
        self.n_launches += 1
        if commit:
            self._state = state        # the carry stays on the device
        fetched = _fetch(out)
        self.n_roundtrips += 1
        bound = crossings(fetched[0], fetched[3], fetched[4], self.alpha)
        # analysis: allow[host-sync] NumPy arrays the one fetch already brought to the host
        win, est, eft, ca, cb, lst, lft, route = (x.tolist() for x in fetched)
        # analysis: allow[host-sync] NumPy arrays the one fetch already brought to the host
        bound = bound.tolist()
        decisions: List[Decision] = []
        # the wave's predecessors are in earlier waves: its commits do not
        # move their keys
        key = self._sort_keys(self.aft)
        for b, j in enumerate(js):
            preds = self._sorted_preds(j, key)
            srcs = [self.proc_of[i] for i in preds]
            d = self._decision(j, win[b], preds, srcs, est[b], eft[b],
                               ca[b], cb[b], lst[b], lft[b], route[b],
                               bound[b], self.want_bound)
            if commit:
                self._commit_host(j, d[0], d[1], d[2], d[3])
            decisions.append(d)
        return decisions

    def evaluate_batch(self, js: Sequence[int]) -> List[Decision]:
        return self._run_batch(js, commit=True)

    def evaluate(self, j: int) -> Decision:
        # a single non-committing evaluation: the kernel runs the slot
        # with real = 0 and the caller commits via apply()
        return self._run_batch([j], commit=False)[0]

    # -------------------------------------------------- whole-plan path
    def stage_plan(self, waves: Sequence[Sequence[int]],
                   alphas: Optional[Sequence[float]]) -> dict:
        """The kernel arguments of a whole plan (:func:`sched_plan`):
        exact ``W x B`` slots (``B`` = widest wave; the tail slots of a
        narrower wave have ``real = 0``), predecessors in graph order
        (the kernel sorts them by the carried ``(aft, id)`` key), and the
        initial carry from the host mirrors."""
        inst = self.inst
        P, K, E = inst.P, self._K, self._E
        W = len(waves)
        B = max((len(w) for w in waves), default=0)
        task = np.zeros((W, B), np.int32)
        real = np.zeros((W, B), np.int32)
        exitf = np.zeros((W, B), np.int32)
        pred = np.zeros((W, B, K), np.int32)
        pvalid = np.zeros((W, B, K), np.int32)
        pedge = np.full((W, B, K), E, np.int32)
        eidx = inst._edge_index
        for wv, js in enumerate(waves):
            for b, j in enumerate(js):
                task[wv, b] = j
                real[wv, b] = 1
                exitf[wv, b] = inst._is_exit[j]
                for k, i in enumerate(inst._preds[j]):
                    pred[wv, b, k] = i
                    pvalid[wv, b, k] = 1
                    pedge[wv, b, k] = eidx[(i, j)]
        al = [self.alpha] if alphas is None else list(alphas)
        proc0 = np.array([p if p >= 0 else P for p in self.proc_of],
                         dtype=np.int32)
        return dict(T=self.tables(), task=self._dev(task),
                    real=self._dev(real), exitf=self._dev(exitf),
                    pred=self._dev(pred), pvalid=self._dev(pvalid),
                    pedge=self._dev(pedge),
                    alphas=self._real(al),
                    period=self.period, state=self._state_from_mirrors(),
                    aft0=self._real(self.aft),
                    proc0=self._dev(proc0))

    def _plan_dispatch(self, waves: Sequence[Sequence[int]],
                       alphas: Optional[Sequence[float]]
                       ) -> Tuple[np.ndarray, ...]:
        """Stage, launch and fetch one whole-plan dispatch; records the
        staging / kernel / fetch split in ``last_timing``."""
        t0 = time.perf_counter()
        args = self.stage_plan(waves, alphas)
        t1 = time.perf_counter()
        out, _state, _aft, _proc = sched_plan(**args)
        self.n_launches += 1
        if self.device.type == "cuda":
            # analysis: allow[host-sync] ends the kernel's share of last_timing; the fetch right after waits for it anyway
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        fetched = _fetch(out)
        self.n_roundtrips += 1
        t3 = time.perf_counter()
        self.last_timing = {"stage_s": t1 - t0, "kernel_s": t2 - t1,
                            "fetch_s": t3 - t2}
        return fetched

    def _decode_plan(self, waves: Sequence[Sequence[int]],
                     fetched: Sequence[np.ndarray], alpha: float,
                     commit: bool, want_bound: bool) -> List[List[Decision]]:
        """Decode one alpha's fetched plan into per-wave decisions.  The
        host re-derives each decision's sorted predecessor order from the
        already decoded AFTs, which equals the kernel's on-device sort."""
        # analysis: allow[host-sync] NumPy arrays the one fetch already brought to the host
        bound = crossings(fetched[0], fetched[3], fetched[4], alpha).tolist()
        # analysis: allow[host-sync] NumPy arrays the one fetch already brought to the host
        win, est, eft, ca, cb, lst, lft, route = (x.tolist() for x in fetched)
        if commit:
            aft_l, proc_l = self.aft, self.proc_of
        else:
            aft_l, proc_l = list(self.aft), list(self.proc_of)
        key = self._sort_keys(aft_l)
        out: List[List[Decision]] = []
        for wv, js in enumerate(waves):
            ds: List[Decision] = []
            for b, j in enumerate(js):
                p = win[wv][b]
                preds = self._sorted_preds(j, key)
                srcs = [proc_l[i] for i in preds]
                d = self._decision(j, p, preds, srcs, est[wv][b],
                                   eft[wv][b], ca[wv][b], cb[wv][b],
                                   lst[wv][b], lft[wv][b], route[wv][b],
                                   bound[wv][b], want_bound)
                if commit:
                    self._commit_host(j, d[0], d[1], d[2], d[3])
                else:
                    proc_l[j] = p
                    aft_l[j] = d[2]
                if key is not aft_l:
                    key[j] = d[2]       # a float32 value: its own key
                ds.append(d)
            out.append(ds)
        return out

    def evaluate_plan(self, waves: Sequence[Sequence[int]],
                      timeout: Optional[float] = None,
                      bid0: int = 0) -> List[List[Decision]]:
        """One ``sched_plan_kernel`` launch for the whole plan (or the
        per-wave loop when ``scan`` is off).  The watchdog compares the
        single dispatch against ``timeout * len(waves)``."""
        if not self.scan or not waves:
            return super().evaluate_plan(waves, timeout=timeout, bid0=bid0)
        t0 = time.monotonic()
        fetched = self._plan_dispatch(waves, None)
        if timeout is not None:
            elapsed = time.monotonic() - t0
            budget = timeout * len(waves)
            if elapsed > budget:
                raise WaveTimeoutError(bid0, elapsed, budget)
        self._state_dirty = True
        t1 = time.perf_counter()
        decisions = self._decode_plan(waves, [x[0] for x in fetched],
                                      self.alpha, True, self.want_bound)
        self.last_timing["decode_s"] = time.perf_counter() - t1
        return decisions

    def supports_plan_sweep(self) -> bool:
        return self.scan

    def evaluate_plan_sweep(self, waves: Sequence[Sequence[int]],
                            alphas: Sequence[float], period: float,
                            timeout: Optional[float] = None
                            ) -> List[List[List[Decision]]]:
        """The fused sweep: one ``sched_plan_kernel`` launch, one block
        per alpha, evaluates every alpha's whole schedule; each alpha
        decodes against its own local AFT/placement lists."""
        alphas = list(alphas)
        if not alphas:
            return []
        if not waves:
            return [[] for _ in alphas]
        t0 = time.monotonic()
        fetched = self._plan_dispatch(waves, alphas)
        if timeout is not None:
            elapsed = time.monotonic() - t0
            budget = timeout * len(waves) * len(alphas)
            if elapsed > budget:
                raise WaveTimeoutError(0, elapsed, budget)
        t1 = time.perf_counter()
        res = [self._decode_plan(waves, [x[ai] for x in fetched], alpha,
                                 False, True)
               for ai, alpha in enumerate(alphas)]
        self.last_timing["decode_s"] = time.perf_counter() - t1
        return res

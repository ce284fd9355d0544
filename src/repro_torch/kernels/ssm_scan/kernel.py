"""Selective scan on the card: the wrapper of the hand-written CUDA
kernel ``selective_scan_kernel`` (``kernels/csrc/ssm_scan.cu``), the
twin of ``repro.kernels.ssm_scan.kernel``.

The TPU kernel's ``block_d``/``block_s`` are its tiling; the CUDA kernel
picks its own, bounded by the one exp of every (batch row, step,
channel, state) on the special-function units.  A thread holds up to 8
states of one channel, so y is summed in registers (and over the N / 8
lanes of a channel with shuffles); a block of 4 warps walks its channels
through chunks of 32 steps, each warp scanning a run of 8 of them from a
zero state while it keeps its decays, then the runs' (product of decays,
state) pairs are folded in order and each run is replayed from its true
carry (:func:`.ref.selective_scan_runs` is that algebra in plain
PyTorch).  The decays are ``2 ** (dt * A log2 e)`` with the hardware's
approximate ``ex2``, log2 e folded into A as it is loaded.

The wrapper checks device, dtype, shape and contiguity and raises on
what the kernel does not take; on CUDA tensors it launches the kernel or
raises, on CPU tensors it runs the plain version
(:func:`.ref.selective_scan_ref`).  :data:`LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ... import _nvcc
from .._common import check_dtype
from .ref import selective_scan_ref

__all__ = ["LAUNCHES", "MAX_STATE", "build_library", "reset_launches",
           "selective_scan_kernel"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ssm_scan.cu"
NVCC_FLAGS = _nvcc.BASE_FLAGS
# the kernel is built for state sizes that are powers of two up to 32
# (one thread holds up to 8 states, a warp up to 4 threads of a channel)
MAX_STATE = 32

LAUNCHES: Dict[str, int] = {"selective_scan_kernel": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load() -> _nvcc.Library:
    built = _nvcc.build("ssm_scan", [SOURCE], NVCC_FLAGS)
    fn = built.lib.selective_scan_launch
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    fn.restype = _I
    return built


_LIB = _nvcc.LibraryCache(_load)


def build_library() -> _nvcc.Library:
    """Build (once per source hash) and load the kernel's library; the
    same handle for every thread."""
    return _LIB.get()


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor) -> None:
    check_dtype((x, dt, Bm, Cm), "selective_scan_kernel")
    if A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError(f"A: expected contiguous float32, got {A.dtype} "
                         f"contiguous={A.is_contiguous()}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"expected x (B, S, Di) and A (Di, N), got "
                         f"{tuple(x.shape)}, {tuple(A.shape)}")
    B, S, Di = x.shape
    N = A.shape[1]
    for t, shp, what in ((dt, (B, S, Di), "dt"), (A, (Di, N), "A"),
                         (Bm, (B, S, N), "Bm"), (Cm, (B, S, N), "Cm")):
        if tuple(t.shape) != shp:
            raise ValueError(f"{what}: expected {shp}, got {tuple(t.shape)}")
    if min(B, S, Di) < 1 or B > 65535:
        raise ValueError(f"need 1 <= B <= 65535 and S, Di >= 1, got "
                         f"B={B} S={S} Di={Di}")
    if not 1 <= N <= MAX_STATE or N & (N - 1):
        raise ValueError(f"state size {N} is not a power of two <= "
                         f"{MAX_STATE}")


def selective_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x, dt (B,S,Di); A (Di,N) float32; Bm, Cm (B,S,N) -> y (B,S,Di) in
    x's dtype (float32 or bfloat16), f32 state."""
    _check(x, dt, A, Bm, Cm)
    if not _nvcc.on_cuda((x, dt, A, Bm, Cm)):
        return selective_scan_ref(x, dt, A, Bm, Cm)
    lib = build_library()
    B, S, Di = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), B, S, Di, A.shape[1],
            int(x.dtype == torch.bfloat16), stream)
    _nvcc.raise_on(rc, "selective_scan_kernel")
    _nvcc.count_launch((LAUNCHES, "selective_scan_kernel"))
    return y

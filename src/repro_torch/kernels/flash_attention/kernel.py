"""Flash attention forward on the card: the wrapper of the hand-written
CUDA kernel ``flash_attention_kernel`` (``kernels/csrc/
flash_attention.cu``), the twin of ``repro.kernels.flash_attention.
kernel``.

The TPU kernel's ``block_q``/``block_k`` are its tiling; the CUDA
kernels pick their own.  The launch function chooses the kernel by the
inputs' dtype:

* bfloat16 runs on the tensor cores (wgmma, TMA, 128 query rows by 64
  keys), bounded by the bf16 tensor-core rate; P.V is two bf16
  products, P's high part and its residual, so P keeps about 17 bits
  and the products match the f32 P.V of the plain version;
* float32 runs on the CUDA cores, since TF32 would miss the f32 path's
  1e-5 tolerance, bounded by the FP32 FMA rate: 8 warps a block (one
  block an SM), 128 query rows by 64 keys, each warp owning 16 rows so
  the softmax stays in registers; a thread holds a 4 x 8 tile of the
  scores and a 4 x d/8 tile of the output, read from shared memory as
  128-bit loads; K and V tiles stream in with cp.async into two stages.
  Its exponent is ``ex2((s - m) * log2 e)``: the running max is
  subtracted before the scaling, so the rounding of the product is
  relative to ``s - m``, not to scores of several hundred.

The wrapper checks device, dtype, shape and contiguity and raises on
what the kernel does not take; on CUDA tensors it launches the kernel or
raises, on CPU tensors it runs the plain version
(:func:`.ref.attention_ref`).  :data:`LAUNCHES` counts kernel launches,
:data:`VARIANT_LAUNCHES` the launches of each of the two kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ... import _nvcc
from .._common import check_dtype
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "VARIANT_LAUNCHES", "build_library",
           "flash_attention_kernel", "reset_launches"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
NVCC_FLAGS = _nvcc.BASE_FLAGS
# head dims the kernel is built for: every one the repo's configs use
HEAD_DIMS = (64, 80, 96, 128)

LAUNCHES: Dict[str, int] = {"flash_attention_kernel": 0}
# the kernel each launch went to: bf16 -> tensor cores, f32 -> CUDA cores
VARIANT_LAUNCHES: Dict[str, int] = {"wgmma_bf16": 0, "fma_f32": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _load() -> _nvcc.Library:
    built = _nvcc.build("flash_attention", [SOURCE], NVCC_FLAGS)
    fn = built.lib.flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    fn.restype = _I
    return built


_LIB = _nvcc.LibraryCache(_load)


def build_library() -> _nvcc.Library:
    """Build (once per source hash) and load the kernel's library; the
    same handle for every thread."""
    return _LIB.get()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    check_dtype((q, k, v), "flash_attention_kernel")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, S, d) and k, v (B, Hkv, S, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, d = q.shape
    Hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, d):
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B, S or d")
    if min(B, Hq, Hkv, S) < 1 or Hq % Hkv != 0:
        raise ValueError(f"need B, S >= 1 and Hq % Hkv == 0, got B={B} "
                         f"Hq={Hq} Hkv={Hkv} S={S}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B}, Hq={Hq} exceed the kernel's grid")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, d), k/v (B, Hkv, S, d) -> (B, Hq, S, d), in q's
    dtype (float32 or bfloat16), f32 math."""
    _check(q, k, v)
    if not _nvcc.on_cuda((q, k, v)):
        return attention_ref(q, k, v, causal=causal)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_kernel: bfloat16 inputs must be "
                         "16-byte aligned (TMA)")
    lib = build_library()
    B, Hq, S, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            k.shape[1], S, d, int(causal), int(bf16), stream)
    _nvcc.raise_on(rc, "flash_attention_kernel")
    _nvcc.count_launch((LAUNCHES, "flash_attention_kernel"),
                       (VARIANT_LAUNCHES, "wgmma_bf16" if bf16 else "fma_f32"))
    return out

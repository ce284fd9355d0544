"""Candidate-evaluation backends for the compiled engine.

  * ``"scalar"`` — :class:`ScalarBackend`, flat Python lists on the host;
    the bit-exactness reference.
  * ``"cuda"`` — :class:`~.cuda.CudaBackend`, the device backend (the
    default): the whole wave plan, and a whole alpha grid, in one
    hand-written CUDA kernel launch on the card.  On a backend built
    with ``device="cpu"`` the kernels' plain PyTorch versions run
    instead.

There is no silent demotion between them: a device backend that cannot
build or launch its kernels raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

from .base import CandidateEvaluator, Decision
from .cuda import CudaBackend
from .scalar import ScalarBackend

__all__ = ["BACKENDS", "CandidateEvaluator", "CudaBackend", "DEFAULT_BACKEND",
           "Decision", "ScalarBackend", "available_backends",
           "backend_class", "resolve_backend_name"]

BACKENDS: Dict[str, Type[CandidateEvaluator]] = {
    ScalarBackend.name: ScalarBackend,
    CudaBackend.name: CudaBackend,
}

DEFAULT_BACKEND = CudaBackend.name


def available_backends() -> List[str]:
    return sorted(BACKENDS)


def resolve_backend_name(backend: Optional[str]) -> str:
    """A requested backend name, validated (``None`` = the device
    backend)."""
    if backend is None:
        return DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; available: "
                         f"{available_backends()}")
    return backend


def backend_class(name: str) -> Type[CandidateEvaluator]:
    """The evaluator class for a resolved backend name."""
    return BACKENDS[resolve_backend_name(name)]

"""Candidate-evaluation backends for the compiled engine.

  * ``"scalar"`` — :class:`ScalarBackend`, flat Python lists on the host;
    the bit-exactness reference.
  * ``"vector"`` — :class:`VectorBackend`, (P,)-batch NumPy array ops on
    the host; bit-identical to scalar, faster from P >= ~8.  Needs
    link-disjoint routes.
  * ``"cuda"`` — :class:`~.cuda.CudaBackend`, the device backend (the
    default): the whole wave plan, and a whole alpha grid, in one
    hand-written CUDA kernel launch on the card.  On a backend built
    with ``device="cpu"`` the kernels' plain PyTorch versions run
    instead.
  * ``"auto"`` — resolves per instance, as the reference's does: vector
    when ``P >= AUTO_VECTOR_MIN_P`` and the routes are link-disjoint,
    scalar otherwise.  It never picks the device backend.

Names are validated at resolve time, before any session state is
built: an unknown name raises ``ValueError``, and an explicit
``"vector"`` on a topology whose routes revisit a link raises
:class:`BackendCompatError`.  There is no silent demotion between
backends: a device backend that cannot build or launch its kernels
raises.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Type

from .base import BackendCompatError, CandidateEvaluator, Decision
from .cuda import CudaBackend
from .scalar import ScalarBackend
from .vector import VectorBackend

if TYPE_CHECKING:                                   # pragma: no cover
    from ..topology import Topology

__all__ = ["AUTO_VECTOR_MIN_P", "BACKENDS", "BackendCompatError",
           "CandidateEvaluator", "CudaBackend", "DEFAULT_BACKEND",
           "Decision", "ScalarBackend", "VectorBackend",
           "available_backends", "backend_class", "resolve_backend_name",
           "vector_compatible"]

BACKENDS: Dict[str, Type[CandidateEvaluator]] = {
    ScalarBackend.name: ScalarBackend,
    VectorBackend.name: VectorBackend,
    CudaBackend.name: CudaBackend,
}

DEFAULT_BACKEND = CudaBackend.name

# "auto" switches to the batched host backend where its (P,)-vector ops
# amortize their per-call cost (the reference's threshold)
AUTO_VECTOR_MIN_P = 8


def available_backends() -> List[str]:
    return sorted(BACKENDS)


def vector_compatible(tg: "Topology") -> bool:
    """Whether every route visits each link at most once, which the
    vector backend's batched scatter needs.  Memoized on the topology:
    ``"auto"`` resolves on every call."""
    ok = getattr(tg, "_vector_compat", None)
    if ok is None:
        ok = all(len(set(r)) == len(r)
                 for rr in tg.routes.values() for r in rr)
        tg._vector_compat = ok
    return ok


def resolve_backend_name(backend: Optional[str], P: int,
                         tg: "Topology") -> str:
    """A requested backend name as a registered one, for ``P``
    processors of ``tg``.  ``None`` is the device backend; ``"auto"``
    is vector for ``P >= AUTO_VECTOR_MIN_P`` on a link-disjoint
    topology and scalar otherwise.  An unknown name raises
    ``ValueError``; an explicit ``"vector"`` on a topology whose routes
    revisit a link raises :class:`BackendCompatError`."""
    if backend is None:
        return DEFAULT_BACKEND
    if backend == "auto":
        if P >= AUTO_VECTOR_MIN_P and vector_compatible(tg):
            return VectorBackend.name
        return ScalarBackend.name
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; available: "
                         f"{available_backends()} or 'auto'")
    if backend == VectorBackend.name and not vector_compatible(tg):
        raise BackendCompatError(
            "a route of this topology visits a link twice; the vector "
            "backend's batched scatter needs link-disjoint routes — "
            "use backend='scalar'")
    return backend


def backend_class(name: str) -> Type[CandidateEvaluator]:
    """The evaluator class for a resolved backend name."""
    cls = BACKENDS.get(name)
    if cls is None:
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{available_backends()} or 'auto'")
    return cls

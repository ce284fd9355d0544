"""Static invariant analyzer of the port, the twin of
:mod:`repro.analysis`, run over ``src/repro_torch``.

Pure-AST passes (nothing imported or executed; no torch, no card) over
one shared :class:`~.index.ProjectIndex` (each file read once):
:mod:`~.kernels` checks the ctypes bindings of the CUDA libraries
against their ``extern "C"`` functions and the no-FMA rounding rule of
the bit-exact scheduling library, :mod:`~.lint` enforces the
bit-exactness/determinism contract of the decision layer,
:mod:`~.typing_gate` checks every backend against the
``CandidateEvaluator`` protocol, and :mod:`~.concurrency` proves the
service layer's hybrid asyncio/thread locking discipline.  Run with
``python -m repro_torch.analysis`` (``--format=json`` for
machine-readable findings).
"""
from .cli import ALL_RULES, main
from .findings import Finding
from .index import ProjectIndex, SourceFile, TextFile

__all__ = ["ALL_RULES", "Finding", "ProjectIndex", "SourceFile", "TextFile",
           "main"]

"""The part of the fault model that the engine and the session read.

Twin of the healthy-path subset of ``repro.core.faults``: the finite
masking sentinels, the normalized :class:`FaultSpec` the
:class:`~.engine.CompiledInstance` masks with, and the two errors the
engine raises.  Fault records, injection (``mark_failed``/``degrade``)
and masked views come with the session's fault methods.

Masking is *finite*: a down processor's computation column is set to
:data:`DOWN_COMP` and a down link's speed to :data:`DOWN_SPEED` rather
than ``inf`` / ``0``, so every backend runs the exact IEEE arithmetic of
the healthy path.  A candidate forced through a masked resource lands at
an EFT beyond :data:`INFEASIBLE_EFT`; if the *winner* lands there, no
feasible placement exists and the engine raises
:class:`InfeasibleScheduleError`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

_INF = float("inf")

DOWN_COMP = 1e18        # comp(task, down proc)
DOWN_SPEED = 1e-18      # effective speed of a down link
INFEASIBLE_EFT = 1e15   # winner EFT at/above this => no feasible placement


class InfeasibleScheduleError(RuntimeError):
    """No feasible placement remains for ``task`` under the active faults."""

    def __init__(self, task: int, eft: float, faults: "FaultSpec") -> None:
        self.task = task
        self.eft = eft
        self.faults = faults
        super().__init__(
            f"no feasible placement for task {task} under active faults "
            f"{faults.describe()} (winning EFT {eft:.3g} exceeds the "
            f"feasibility horizon)")


class WaveTimeoutError(RuntimeError):
    """A candidate-evaluation dispatch exceeded the engine watchdog budget
    (``CompiledInstance.wave_timeout``)."""

    def __init__(self, wave: int, elapsed: float, timeout: float) -> None:
        self.wave = wave
        self.elapsed = elapsed
        self.timeout = timeout
        super().__init__(
            f"candidate-evaluation wave {wave} took {elapsed:.3f}s "
            f"(watchdog budget {timeout:.3f}s)")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Normalized snapshot of the active resource faults.

    ``down_procs`` is a sorted tuple of processor indices;
    ``link_factors`` a sorted tuple of ``(link_name, factor)`` pairs
    where ``factor == inf`` means the link is down.  The empty spec is
    the healthy system.
    """

    down_procs: Tuple[int, ...] = ()
    link_factors: Tuple[Tuple[str, float], ...] = ()

    @property
    def is_empty(self) -> bool:
        return not self.down_procs and not self.link_factors

    @property
    def down_links(self) -> Tuple[str, ...]:
        return tuple(l for l, f in self.link_factors if f == _INF)

    def link_factor(self, link: str) -> float:
        for l, f in self.link_factors:
            if l == link:
                return f
        return 1.0

    def effective_speed(self, link: str, raw_speed: float) -> float:
        """Masked speed of one link (:data:`DOWN_SPEED` when down)."""
        f = self.link_factor(link)
        if f == _INF:
            return DOWN_SPEED
        return raw_speed / f

    def describe(self) -> str:
        parts = [f"proc {p} down" for p in self.down_procs]
        for l, f in self.link_factors:
            parts.append(f"link {l} down" if f == _INF
                         else f"link {l} degraded x{f:g}")
        return "[" + ", ".join(parts) + "]" if parts else "[none]"

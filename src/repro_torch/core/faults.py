"""Fault model for fault-tolerant scheduling.

Twin of ``repro.core.faults``.  Automotive DSMSs lose resources mid-run:
an ECU stalls (:class:`ProcessorDown`), a CAN/FlexRay segment degrades
or drops (:class:`LinkDegraded` / :class:`LinkDown`), a task's
computation time spikes under load (:class:`ComputeSpike`).  This module
is the *model* only: declarative fault records, a normalized
:class:`FaultSpec`, and pure masked views of a
:class:`~.topology.Topology` / :class:`~.graph.SPG`.  Injection and
replanning live in :meth:`api.Scheduler.mark_failed` /
:meth:`api.Scheduler.degrade`; enforcement lives in
:class:`~.engine.CompiledInstance` (masked comp columns / effective link
speeds, which the device backend reads from its tables like every other
value) and :mod:`.validate` (the independent oracle).

Masking is *finite*: a down processor's computation column is set to
:data:`DOWN_COMP` and a down link's speed to :data:`DOWN_SPEED` rather
than ``inf`` / ``0``, so every backend runs the exact IEEE arithmetic of
the healthy path.  A candidate forced through a masked resource lands at
an EFT beyond :data:`INFEASIBLE_EFT`; if the *winner* lands there, no
feasible placement exists and the engine raises
:class:`InfeasibleScheduleError`.

The priority heuristics (rank / LDET / HPRV queues) keep the *healthy*
topology: priorities are estimates, not feasibility, and freezing them
is what makes the fault-invalidation rule exact: the decision-trace
prefix untouched by the failed resource is provably unchanged and is
re-committed rather than re-simulated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

from .graph import SPG
from .topology import Topology

_INF = float("inf")

DOWN_COMP = 1e18        # comp(task, down proc)
DOWN_SPEED = 1e-18      # effective speed of a down link
INFEASIBLE_EFT = 1e15   # winner EFT at/above this => no feasible placement


class InfeasibleScheduleError(RuntimeError):
    """No feasible placement remains for ``task`` under the active faults
    (raised the moment a decision's winning candidate is only reachable
    through a masked resource)."""

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
    (``CompiledInstance.wave_timeout``).  It propagates out of the
    session call: the port keeps no fallback to demote to."""

    def __init__(self, wave: int, elapsed: float, timeout: float) -> None:
        self.wave = wave
        self.elapsed = elapsed
        self.timeout = timeout
        super().__init__(
            f"candidate-evaluation wave {wave} took {elapsed:.3f}s "
            f"(watchdog budget {timeout:.3f}s)")


# ----------------------------------------------------------------------
# Declarative fault records
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ProcessorDown:
    """Processor ``proc`` (index into ``Topology.proc_names``) is dead."""

    proc: int


@dataclasses.dataclass(frozen=True)
class LinkDegraded:
    """Link ``link`` runs at ``1/factor`` of its nominal speed
    (``factor >= 1``: CTML of every message on it scales by factor)."""

    link: str
    factor: float


@dataclasses.dataclass(frozen=True)
class LinkDown:
    """Link ``link`` is unusable (equivalent to an infinite factor)."""

    link: str


@dataclasses.dataclass(frozen=True)
class ComputeSpike:
    """Task ``task``'s computational volume scales by ``factor``.

    Flows through the same arrival-rate-drift machinery as
    :meth:`api.Scheduler.update` (``task_rates``); kept in the taxonomy
    so fault scripts can be declared uniformly.
    """

    task: int
    factor: float


Fault = Union[ProcessorDown, LinkDegraded, LinkDown, ComputeSpike]


# ----------------------------------------------------------------------
# Normalized fault state
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Normalized, hashable snapshot of the active resource faults.

    ``down_procs`` is a sorted tuple of processor indices;
    ``link_factors`` a sorted tuple of ``(link_name, factor)`` pairs
    where ``factor == inf`` means the link is down.  (:class:`ComputeSpike`
    is *not* part of the spec — computation drift rescales the graph and
    rides the existing ``update(task_rates=...)`` path.)
    """

    down_procs: Tuple[int, ...] = ()
    link_factors: Tuple[Tuple[str, float], ...] = ()

    # ------------------------------------------------------------- build
    @classmethod
    def from_faults(cls, faults: Iterable[Fault],
                    tg: Topology) -> "FaultSpec":
        """Validate resource ids against ``tg`` and normalize.

        Later records override earlier ones for the same link;
        :class:`ComputeSpike` records are rejected here (they are graph
        drift, not resource state — apply them via
        ``Scheduler.degrade(task=...)`` / ``update(task_rates=...)``).
        """
        down = set()
        factors: Dict[str, float] = {}
        for f in faults:
            if isinstance(f, ProcessorDown):
                if not 0 <= f.proc < tg.n_procs:
                    raise ValueError(
                        f"ProcessorDown: processor index {f.proc} out of "
                        f"range for a {tg.n_procs}-processor topology")
                down.add(int(f.proc))
            elif isinstance(f, LinkDegraded):
                _check_link(f.link, tg)
                fac = float(f.factor)
                if not np.isfinite(fac) or fac <= 0.0:
                    raise ValueError(
                        f"LinkDegraded: factor must be a finite positive "
                        f"number, got {f.factor!r} (use LinkDown for an "
                        f"unusable link)")
                factors[f.link] = fac
            elif isinstance(f, LinkDown):
                _check_link(f.link, tg)
                factors[f.link] = _INF
            elif isinstance(f, ComputeSpike):
                raise ValueError(
                    "ComputeSpike is computation drift, not resource "
                    "state: apply it via Scheduler.degrade(task=..., "
                    "factor=...) or update(task_rates=...)")
            else:
                raise TypeError(f"not a fault record: {f!r}")
        if len(down) >= tg.n_procs:
            raise ValueError("every processor marked down — nothing left "
                             "to schedule on")
        return cls(tuple(sorted(down)),
                   tuple(sorted(factors.items())))

    # ----------------------------------------------------------- queries
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

    # ----------------------------------------------------------- algebra
    def with_fault(self, fault: Fault, tg: Topology) -> "FaultSpec":
        """Spec with one more fault applied (link records override)."""
        merged = list(self._records()) + [fault]
        return FaultSpec.from_faults(merged, tg)

    def without(self, *, proc: Optional[int] = None,
                link: Optional[str] = None) -> "FaultSpec":
        """Spec with one resource restored (no-op if it was healthy)."""
        down = tuple(p for p in self.down_procs if p != proc)
        factors = tuple((l, f) for l, f in self.link_factors if l != link)
        return FaultSpec(down, factors)

    def _records(self) -> Tuple[Fault, ...]:
        recs: list = [ProcessorDown(p) for p in self.down_procs]
        for l, f in self.link_factors:
            recs.append(LinkDown(l) if f == _INF else LinkDegraded(l, f))
        return tuple(recs)


def _check_link(link: str, tg: Topology) -> None:
    if link not in tg.link_speed:
        raise ValueError(f"unknown link {link!r} (topology links: "
                         f"{tg.all_links()})")


# ----------------------------------------------------------------------
# Pure masked views
# ----------------------------------------------------------------------
def apply_to_topology(tg: Topology, spec: FaultSpec) -> Topology:
    """A new :class:`Topology` whose link speeds carry the fault masking.

    Pure view: ``tg`` is untouched.  Down links get speed 0.0 (their
    CTML is ``inf`` — :meth:`Topology.ctml` guards the division), so the
    view is honest for inspection and the validator; the *engine* masks
    at the :class:`~.engine.CompiledInstance` level instead (finite
    :data:`DOWN_SPEED`, see module docstring) and never consumes this.
    Down processors cannot be dropped from a topology without renaming
    every index, so they are not represented here — processor masking is
    a property of the spec, not the view.
    """
    speeds = {l: (0.0 if spec.link_factor(l) == _INF
                  else s / spec.link_factor(l))
              for l, s in tg.link_speed.items()}
    return Topology(list(tg.proc_names), tg.rates.copy(), speeds,
                    {pair: list(rr) for pair, rr in tg.routes.items()},
                    ctml_mode=tg.ctml_mode)


def apply_to_graph(g: SPG, spikes: Iterable[ComputeSpike]) -> SPG:
    """A new :class:`SPG` with :class:`ComputeSpike` volume scaling
    applied (pure view; structure/names preserved)."""
    w = g.weights.copy()
    cm = None if g.comp_matrix is None else np.array(g.comp_matrix,
                                                    dtype=float)
    for s in spikes:
        if not 0 <= s.task < g.n:
            raise ValueError(f"ComputeSpike: task {s.task} out of range "
                             f"for a {g.n}-task graph")
        fac = float(s.factor)
        if not np.isfinite(fac) or fac <= 0.0:
            raise ValueError(f"ComputeSpike: factor must be a finite "
                             f"positive number, got {s.factor!r}")
        w[s.task] *= fac
        if cm is not None:
            cm[s.task] *= fac
    return SPG(n=g.n, edges=list(g.edges), weights=w, tpl=dict(g.tpl),
               tpl_proportional_ccr=g.tpl_proportional_ccr,
               comp_matrix=cm, name=g.name)

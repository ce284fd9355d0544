"""HVLB_CC (A) and (B) one-shot entry points — deprecated shims.

Twin of ``repro.core.hvlb_cc``: each wraps a throwaway single-graph
:class:`~.api.Scheduler` and returns bit-identical results to the
session; new code should hold a ``Scheduler``, which shares the compiled
instance, priority queues and decision traces across calls and exposes
``submit_many`` / incremental ``update``.  They emit a
:class:`DeprecationWarning` once per process.  ``device`` is where the
session's cuda backend runs (the card unless the caller asks for the
CPU).
"""
from __future__ import annotations

from typing import Optional

from .api import HVLB_CC_A, HVLB_CC_B, Scheduler, SweepResult
from .deprecation import warn_once
from .graph import SPG
from .scheduler import Schedule
from .topology import Topology

__all__ = ["SweepResult", "schedule_hvlb_cc", "schedule_hvlb_cc_best"]


def _run(g: SPG, tg: Topology, variant: str = "A", alpha_max: float = 3.0,
         alpha_step: float = 0.01, period: Optional[float] = None,
         depth_power: int = 2, outd_mode: str = "indicator",
         engine: str = "compiled", sweep: str = "grid",
         coarse_factor: int = 10,
         backend: Optional[str] = None,
         device: Optional[str] = None) -> SweepResult:
    """Shared implementation (and single source of defaults) of the two
    deprecated shims below."""
    if variant.upper() == "A":
        policy = HVLB_CC_A(alpha_max=alpha_max, alpha_step=alpha_step,
                           period=period, sweep=sweep,
                           coarse_factor=coarse_factor)
    elif variant.upper() == "B":
        policy = HVLB_CC_B(alpha_max=alpha_max, alpha_step=alpha_step,
                           period=period, sweep=sweep,
                           coarse_factor=coarse_factor,
                           depth_power=depth_power, outd_mode=outd_mode)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return Scheduler(tg, policy=policy, engine=engine, backend=backend,
                     device=device).submit(g).sweep


def schedule_hvlb_cc(g: SPG, tg: Topology, variant: str = "A",
                     alpha_max: float = 3.0, alpha_step: float = 0.01,
                     period: Optional[float] = None,
                     depth_power: int = 2,
                     outd_mode: str = "indicator",
                     engine: str = "compiled",
                     sweep: str = "grid",
                     coarse_factor: int = 10,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> SweepResult:
    """Algorithm 1: sweep alpha in [0, alpha_max], keep min makespan.

    .. deprecated:: use ``Scheduler(tg, policy=HVLB_CC_A(...)).submit(g)``;
       the returned ``Plan.sweep`` is this function's ``SweepResult``.
    """
    warn_once("schedule_hvlb_cc",
              "schedule_hvlb_cc is deprecated; use repro_torch.core."
              "Scheduler with an HVLB_CC_A/HVLB_CC_B policy")
    return _run(g, tg, variant, alpha_max, alpha_step, period, depth_power,
                outd_mode, engine, sweep, coarse_factor, backend, device)


def schedule_hvlb_cc_best(g: SPG, tg: Topology, **kw) -> Schedule:
    """Deprecated: ``Scheduler(...).submit(g).schedule``."""
    warn_once("schedule_hvlb_cc_best",
              "schedule_hvlb_cc_best is deprecated; use "
              "repro_torch.core.Scheduler")
    return _run(g, tg, **kw).best

"""HSV_CC baseline (Xie et al. [25]) one-shot entry point — deprecated shim.

Twin of ``repro.core.hsv_cc``: wraps :class:`~.api.Scheduler` with the
:class:`~.api.HSV_CC` policy (priorities Eq. 8, selection EFT * LDET_CC —
HVLB_CC with alpha = 0).  Emits a ``DeprecationWarning`` once per
process; new code should use the session API directly.  ``device`` is
where the session's cuda backend runs (the card unless the caller asks
for the CPU).
"""
from __future__ import annotations

from typing import Optional

from .api import HSV_CC, Scheduler
from .deprecation import warn_once
from .graph import SPG
from .scheduler import Schedule
from .topology import Topology

__all__ = ["schedule_hsv_cc"]


def schedule_hsv_cc(g: SPG, tg: Topology, engine: str = "compiled",
                    backend: Optional[str] = None,
                    device: Optional[str] = None) -> Schedule:
    """Deprecated: ``Scheduler(tg, policy=HSV_CC()).submit(g).schedule``."""
    warn_once("schedule_hsv_cc",
              "schedule_hsv_cc is deprecated; use repro_torch.core."
              "Scheduler with the HSV_CC policy")
    return Scheduler(tg, policy=HSV_CC(), engine=engine, backend=backend,
                     device=device).submit(g).schedule

"""Experimental metrics: SLR (Eq. 22), speedup (Eq. 23), LB (Eqs. 24-25),
SFR (Eq. 26).  Twin of ``repro.core.metrics``."""
from __future__ import annotations

from .scheduler import Schedule


def slr(s: Schedule) -> float:
    """Schedule-length ratio: makespan over the min-comp critical path."""
    g, tg = s.graph, s.topology
    cp = g.critical_path_min_comp(tg.rates, tg.n_procs)
    return s.makespan / cp


def speedup(s: Schedule) -> float:
    """Min sequential execution time over makespan."""
    g, tg = s.graph, s.topology
    seq = min(sum(g.comp(i, p, tg.rates) for i in range(g.n))
              for p in range(tg.n_procs))
    return seq / s.makespan


def load_balance(s: Schedule) -> float:
    """LB = makespan / Avg (lower is better; 1.0 is perfectly balanced)."""
    loads = s.proc_loads()
    avg = loads.sum() / s.topology.n_procs
    return s.makespan / avg


def sfr(failures: int, total: int) -> float:
    """Scheduling failure rate, percent (Eq. 26)."""
    return 100.0 * failures / total

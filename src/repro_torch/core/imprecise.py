"""Imprecise-computation extension HVLB_CC_IC (Section 4.4).

A task subject to varying input arrival rates is split into a *mandatory*
part and an *optional* part (Eq. 19).  The optional part may run inside a
*schedule hole*: processor idle time after the task that can be consumed
without delaying (a) the next task on the same processor, (b) any
same-processor successor, or (c) the departure of any outgoing message,
where messages may themselves be re-timed into link idle slots as long as no
successor's start is pushed back (Eqs. 20-21; the paper's LST'' re-timing).

Precision of a task under arrival rate lambda (Experiment 5):
  requested optional time  op_req = (lambda - 1) * mp
  executed optional time   op_run = min(op_req, hole)   (0 without IC)
  precision = (mp + op_run) / (mp + op_req)

Twin of ``repro.core.imprecise``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .scheduler import Schedule


def schedule_holes(s: Schedule,
                   include_unbounded: bool = False) -> Dict[int, float]:
    """Maximum extension time available after each task (Eqs. 20-21).

    A task with *nothing* after it — no later task on its processor, no
    successor anywhere — has an unbounded hole.  By default such tasks
    are omitted (matching tasks with no usable hole); with
    ``include_unbounded=True`` they are reported as ``float("inf")``,
    which is what the imprecise-computation consumers want (``min(op_req,
    inf) == op_req``: the optional part always fits).
    """
    g, tg = s.graph, s.topology
    holes: Dict[int, float] = {}
    link_ivs = s.link_intervals()

    for p_task in range(g.n):
        p = int(s.proc[p_task])
        aft = float(s.finish[p_task])
        bounds: List[float] = []

        # (a) next task on the same processor
        on_p = s.tasks_on(p)
        idx = on_p.index(p_task)
        if idx + 1 < len(on_p):
            bounds.append(float(s.start[on_p[idx + 1]]))

        for n_s in g.succ[p_task]:
            if int(s.proc[n_s]) == p:
                # (b) same-processor successor: condition 1 (Eq. 20)
                bounds.append(float(s.start[n_s]))
            else:
                # (c) different processor: condition 2 (Eq. 21) — the
                # message may be delayed to LST'' = LST + slack, where the
                # slack is limited by the successor's start and by the next
                # message queued behind it on every link of its route.
                m = s.messages[(p_task, n_s)]
                slack = float(s.start[n_s]) - m.lft
                for (l, st, fi) in m.intervals:
                    nxt = [iv for iv in link_ivs[l] if iv[0] >= fi - 1e-9
                           and iv[2] != m.edge]
                    if nxt:
                        slack = min(slack, nxt[0][0] - fi)
                bounds.append(m.lst + max(0.0, slack))

        if not bounds:
            # exit task with nothing after it: unbounded hole
            if include_unbounded:
                holes[p_task] = float("inf")
            continue
        hole = min(bounds) - aft
        if hole > 1e-9:
            holes[p_task] = hole
    return holes


def precision(mp: float, hole: float, lam: float, *, ic: bool) -> float:
    """Data precision of one imprecise task at arrival rate ``lam``."""
    op_req = (lam - 1.0) * mp
    if op_req <= 0:
        return 1.0
    op_run = min(op_req, hole) if ic else 0.0
    return (mp + op_run) / (mp + op_req)


def precision_curve(s: Schedule, tasks: List[int], lams: np.ndarray,
                    *, ic: bool) -> Dict[int, np.ndarray]:
    """Experiment-5 curves for the given imprecise-model tasks."""
    g, tg = s.graph, s.topology
    holes = schedule_holes(s)
    out: Dict[int, np.ndarray] = {}
    for t in tasks:
        mp = g.comp(t, int(s.proc[t]), tg.rates)
        hole = holes.get(t, 0.0)
        out[t] = np.array([precision(mp, hole, l, ic=ic) for l in lams])
    return out

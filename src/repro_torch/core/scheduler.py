"""Processor-selection + scheduling phase (Sections 4.2-4.3).

Tasks are dequeued in HPRV order and placed on the processor minimizing the
selection value; their incoming messages are simultaneously scheduled onto
concrete links of a concrete route with contention (scalar per-link
availability — the bus semantics of the paper): Eqs. 10-15.

Selection values:
  HSV_CC  = EFT * LDET_CC                        (baseline, Xie et al. [25])
  HVLB_CC = EFT * LDET_CC * BP(p, alpha)         (Def. 4.2; exits use EFT only)

Twin of ``repro.core.scheduler``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import SPG
from .ranks import ldet_cc
from .topology import Route, Topology


class SchedulingFailure(Exception):
    """Raised when a task is dequeued before one of its predecessors was
    scheduled — the failure mode of Section 3.2 / Experiment 4."""


@dataclasses.dataclass
class MessagePlacement:
    edge: Tuple[int, int]
    src_proc: int
    dst_proc: int
    route: Route
    # per-link (start, finish) in route order: LST/LFT of Eqs. 13-14
    intervals: List[Tuple[str, float, float]]

    @property
    def lft(self) -> float:
        return self.intervals[-1][2]

    @property
    def lst(self) -> float:
        return self.intervals[0][1]


@dataclasses.dataclass
class Schedule:
    graph: SPG
    topology: Topology
    proc: np.ndarray            # task -> processor
    start: np.ndarray           # task -> AST
    finish: np.ndarray          # task -> AFT
    messages: Dict[Tuple[int, int], MessagePlacement]
    alpha: Optional[float] = None

    @property
    def makespan(self) -> float:
        return float(self.finish.max())

    def tasks_on(self, p: int) -> List[int]:
        order = [i for i in range(self.graph.n) if self.proc[i] == p]
        return sorted(order, key=lambda i: self.start[i])

    def link_intervals(self) -> Dict[str, List[Tuple[float, float, Tuple[int, int]]]]:
        out: Dict[str, List[Tuple[float, float, Tuple[int, int]]]] = {}
        for e, m in self.messages.items():
            for (l, s, f) in m.intervals:
                out.setdefault(l, []).append((s, f, e))
        for l in out:
            out[l].sort()
        return out

    def proc_loads(self) -> np.ndarray:
        """Cumulative computation time per processor (Eq. 25 numerator)."""
        loads = np.zeros(self.topology.n_procs)
        for i in range(self.graph.n):
            loads[self.proc[i]] += self.finish[i] - self.start[i]
        return loads

    def validate(self) -> None:
        """Assert the schedule invariants (used by the property tests)."""
        g, tg = self.graph, self.topology
        eps = 1e-9
        for i in range(g.n):
            assert self.finish[i] >= self.start[i] - eps
            expected = g.comp(i, int(self.proc[i]), tg.rates)
            assert abs((self.finish[i] - self.start[i]) - expected) < 1e-6, \
                f"task {i} duration mismatch"
        # no overlap per processor
        for p in range(tg.n_procs):
            ts = self.tasks_on(p)
            for a, b in zip(ts, ts[1:]):
                assert self.start[b] >= self.finish[a] - eps, \
                    f"tasks {a},{b} overlap on p{p}"
        # precedence + message timing
        for (i, j) in g.edges:
            if self.proc[i] == self.proc[j]:
                assert self.start[j] >= self.finish[i] - eps
            else:
                m = self.messages[(i, j)]
                assert m.lst >= self.finish[i] - eps
                assert self.start[j] >= m.lft - eps
        # no overlap per link
        for l, ivs in self.link_intervals().items():
            for (s1, f1, _), (s2, f2, _) in zip(ivs, ivs[1:]):
                assert s2 >= f1 - eps, f"messages overlap on {l}"


# ----------------------------------------------------------------------
def _route_message(g: SPG, tg: Topology, i: int, j: int, src: int, dst: int,
                   aft_i: float, link_free: Dict[str, float],
                   ) -> MessagePlacement:
    """Schedule message e_{i,j} on the best route src->dst (Eqs. 13-15).

    Wormhole-style pipelining exactly as the recurrences state: the message
    may start on link x+1 as soon as both that link is free and it has
    started on link x; per-link finish is monotone (Eq. 14's outer max).
    Among the available routes the one with the earliest arrival (final LFT)
    wins; ties prefer fewer hops then route order.
    """
    comp_src = g.comp(i, src, tg.rates)
    tpl = g.comm_volume(i, j, comp_src)
    best: Optional[MessagePlacement] = None
    best_key: Tuple[float, int, int] = (np.inf, 0, 0)
    for ridx, route in enumerate(tg.routes[(src, dst)]):
        intervals: List[Tuple[str, float, float]] = []
        lst_prev = None
        lft_prev = 0.0
        for l in route:
            avail = link_free.get(l, 0.0)
            if lst_prev is None:
                lst = max(aft_i, avail)                      # Eq. 13 (first)
            else:
                lst = max(lst_prev, avail)                   # Eq. 13 (next)
            ctml = tg.ctml(tpl, l)                           # Eq. 15
            lft = max(lft_prev, lst + ctml)                  # Eq. 14
            intervals.append((l, lst, lft))
            lst_prev, lft_prev = lst, lft
        key = (lft_prev, len(route), ridx)
        if key < best_key:
            best_key = key
            best = MessagePlacement((i, j), src, dst, route, intervals)
    assert best is not None
    return best


@dataclasses.dataclass
class _Candidate:
    proc: int
    est: float
    eft: float
    value: float
    msgs: List[MessagePlacement]


def _evaluate(g: SPG, tg: Topology, j: int, p: int, rank: np.ndarray,
              ldet: np.ndarray, proc_free: np.ndarray,
              link_free: Dict[str, float], aft: np.ndarray,
              proc_of: np.ndarray, bp: float) -> _Candidate:
    """EST/EFT (Eqs. 10-12) and the selection value for candidate p."""
    msgs: List[MessagePlacement] = []
    tentative = dict(link_free)
    arrival = 0.0
    # schedule this task's incoming messages in message-ready order
    for i in sorted(g.pred[j], key=lambda i: (aft[i], i)):
        src = int(proc_of[i])
        if src == p:
            arrival = max(arrival, aft[i])
            continue
        m = _route_message(g, tg, i, j, src, p, aft[i], tentative)
        for (l, s, f) in m.intervals:
            tentative[l] = max(tentative.get(l, 0.0), f)
        msgs.append(m)
        arrival = max(arrival, m.lft)
    est = max(proc_free[p], arrival)                         # Eqs. 10-11
    eft = est + g.comp(j, p, tg.rates)                       # Eq. 12
    if not g.succ[j]:                                        # exit task
        value = eft                                          # Def. 4.2
    else:
        value = eft * ldet[j, p] * bp
    return _Candidate(p, est, eft, value, msgs)


def list_schedule(g: SPG, tg: Topology, queue: Sequence[int],
                  rank: np.ndarray, alpha: float = 0.0,
                  period: Optional[float] = None,
                  bp_on_exit: bool = True,
                  ldet: Optional[np.ndarray] = None) -> Schedule:
    """Run the processor-selection phase for a given priority queue.

    ``alpha == 0`` makes BP == 1 everywhere and the algorithm *is* HSV_CC.
    ``period`` defaults to the sum of min computation times of the graph
    (the DAG's deadline proxy; Definition 4.1 normalizes processor load by
    the application period).  ``ldet`` may be passed in to share the Eq. 16
    matrix across repeated calls (the alpha sweep); it defaults to
    ``ldet_cc(g, tg, rank)``.

    This is the readable reference implementation; the compiled engine in
    :mod:`repro_torch.core.engine` reproduces it bit-for-bit on flat arrays.
    """
    P = tg.n_procs
    if ldet is None:
        ldet = ldet_cc(g, tg, rank)
    if period is None:
        period = g.default_period(tg.rates, P)
    proc_free = np.zeros(P)
    link_free: Dict[str, float] = {}
    proc_of = np.full(g.n, -1, dtype=int)
    ast = np.zeros(g.n)
    aft = np.zeros(g.n)
    loads = np.zeros(P)           # cumulative comp time per processor
    messages: Dict[Tuple[int, int], MessagePlacement] = {}
    scheduled = np.zeros(g.n, dtype=bool)

    for j in queue:
        for i in g.pred[j]:
            if not scheduled[i]:
                raise SchedulingFailure(
                    f"task {j} dequeued before predecessor {i} (Sec. 3.2)")
        best: Optional[_Candidate] = None
        for p in range(P):
            bp = 1.0 + (loads[p] / period) * alpha           # Def. 4.1
            cand = _evaluate(g, tg, j, p, rank, ldet, proc_free,
                             link_free, aft, proc_of, bp)
            if best is None or (cand.value, cand.eft, cand.proc) < \
                    (best.value, best.eft, best.proc):
                best = cand
        assert best is not None
        p = best.proc
        proc_of[j] = p
        ast[j], aft[j] = best.est, best.eft
        proc_free[p] = best.eft
        loads[p] += g.comp(j, p, tg.rates)
        for m in best.msgs:
            messages[m.edge] = m
            for (l, s, f) in m.intervals:
                link_free[l] = max(link_free.get(l, 0.0), f)
        scheduled[j] = True

    return Schedule(g, tg, proc_of, ast, aft, messages, alpha=alpha)

"""Independent schedule validation + session-boundary input checks.

:func:`schedule_violations` re-derives every structural invariant of a
:class:`~.scheduler.Schedule` from the placements and message intervals
alone — deliberately *not* reusing the engine's own bookkeeping
(``Schedule.validate`` asserts from inside the producing code path; this
module is the oracle the chaos harness judges it by):

  * **precedence** — a same-processor successor starts at/after its
    predecessor's finish; a cross-processor successor starts at/after
    the final hop LFT of its message, whose first hop starts at/after
    the predecessor's finish (Eqs. 10-14);
  * **processor exclusivity** — tasks sharing a processor never overlap;
  * **link-contention exclusivity** — message occupancy intervals
    sharing a link never overlap (Section 2.3's contended network);
  * **route feasibility** — every message travels a route the topology
    actually defines between its endpoint processors, hop links in
    route order;
  * **duration** — every task occupies exactly ``comp(task, proc)``;
  * **fault avoidance** (with a :class:`~.faults.FaultSpec`) — nothing
    is placed on a down processor, no message occupies a down link.

The ``check_*`` helpers are the actionable input validation used at the
:class:`~.api.Scheduler` session boundary (reject NaN/zero/negative
rates and speeds, unknown task ids, malformed graphs) so bad input
fails with a one-line ``ValueError`` instead of a deep engine/NumPy
stack trace.

Twin of ``repro.core.validate``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .faults import FaultSpec
from .graph import SPG
from .scheduler import Schedule
from .topology import Topology

# Comparison slack for re-derived invariants: engine floats are exact
# (every commit is plain IEEE arithmetic), but the duration check
# re-multiplies weight x rate, so allow a few ulps of headroom.
_EPS = 1e-9
# The slack for a plan of the device backend's float32 mode: its times
# are float32 sums (an EFT is est + comp rounded to float32, its comp a
# float32 too), so a duration is comp to within 2**-23 of the horizon;
# four times that.  Every other invariant holds exactly there as well.
FLOAT32_RTOL = 4 * 2.0 ** -23


class ScheduleValidationError(ValueError):
    """A schedule violated an independent structural invariant."""

    def __init__(self, violations: List[str]) -> None:
        self.violations = violations
        super().__init__(
            f"{len(violations)} schedule violation(s):\n  " +
            "\n  ".join(violations))


def schedule_violations(s: Schedule,
                        spec: Optional[FaultSpec] = None,
                        rtol: float = _EPS) -> List[str]:
    """Every invariant violation of ``s`` (empty list == valid).  ``rtol``
    is the comparisons' slack relative to the horizon: the float64
    default, or :data:`FLOAT32_RTOL` for a plan of the device backend's
    float32 mode."""
    g, tg = s.graph, s.topology
    out: List[str] = []
    horizon = float(max(s.finish.max(), 1.0)) if g.n else 1.0
    tol = rtol * horizon
    down_links = set(spec.down_links) if spec is not None else set()
    down_procs = set(spec.down_procs) if spec is not None else set()

    # --- task placement / duration / fault avoidance ---
    for t in range(g.n):
        p = int(s.proc[t])
        if not 0 <= p < tg.n_procs:
            out.append(f"task {t}: placed on invalid processor {p}")
            continue
        if p in down_procs:
            out.append(f"task {t}: placed on down processor {p}")
        st, fi = float(s.start[t]), float(s.finish[t])
        if not (math.isfinite(st) and math.isfinite(fi)) or fi < st:
            out.append(f"task {t}: malformed interval [{st}, {fi}]")
            continue
        comp = g.comp(t, p, tg.rates)
        if abs((fi - st) - comp) > tol + rtol * abs(comp):
            out.append(f"task {t}: duration {fi - st:.9g} != "
                       f"comp(t, p{p}) = {comp:.9g}")

    # --- processor exclusivity ---
    by_proc: Dict[int, List[int]] = {}
    for t in range(g.n):
        by_proc.setdefault(int(s.proc[t]), []).append(t)
    for p, tasks in by_proc.items():
        tasks.sort(key=lambda t: (float(s.start[t]), float(s.finish[t])))
        for a, b in zip(tasks, tasks[1:]):
            if float(s.finish[a]) > float(s.start[b]) + tol:
                out.append(f"processor {p}: tasks {a} and {b} overlap "
                           f"([{s.start[a]:.6g}, {s.finish[a]:.6g}] vs "
                           f"[{s.start[b]:.6g}, {s.finish[b]:.6g}])")

    # --- precedence + per-message structure ---
    for (i, j) in g.edges:
        pi, pj = int(s.proc[i]), int(s.proc[j])
        if pi == pj:
            if (i, j) in s.messages:
                out.append(f"edge ({i},{j}): same-processor edge carries "
                           f"a message")
            if float(s.start[j]) + tol < float(s.finish[i]):
                out.append(f"edge ({i},{j}): successor starts "
                           f"{s.start[j]:.6g} before predecessor "
                           f"finishes {s.finish[i]:.6g}")
            continue
        m = s.messages.get((i, j))
        if m is None:
            out.append(f"edge ({i},{j}): cross-processor edge "
                       f"p{pi}->p{pj} has no message placement")
            continue
        # route feasibility
        if m.src_proc != pi or m.dst_proc != pj:
            out.append(f"edge ({i},{j}): message endpoints p{m.src_proc}->"
                       f"p{m.dst_proc} do not match placements "
                       f"p{pi}->p{pj}")
        route = tuple(m.route)
        legal = [tuple(r) for r in tg.routes.get((pi, pj), [])]
        if route not in legal:
            out.append(f"edge ({i},{j}): route {route} is not a "
                       f"topology route p{pi}->p{pj}")
        hops = [l for (l, _st, _fi) in m.intervals]
        if hops != list(route):
            out.append(f"edge ({i},{j}): interval links {hops} do not "
                       f"follow route {route}")
        # hop timing: first hop after predecessor finish, hops ordered,
        # successor after final-hop LFT (Eqs. 13-14)
        prev_lst = -math.inf
        prev_lft = -math.inf
        for k, (l, lst, lft) in enumerate(m.intervals):
            if l in down_links:
                out.append(f"edge ({i},{j}): message occupies down "
                           f"link {l}")
            if not (math.isfinite(lst) and math.isfinite(lft)) \
                    or lft + tol < lst:
                out.append(f"edge ({i},{j}) hop {k} ({l}): malformed "
                           f"interval [{lst}, {lft}]")
                continue
            if k == 0 and lst + tol < float(s.finish[i]):
                out.append(f"edge ({i},{j}): first hop starts "
                           f"{lst:.6g} before predecessor finishes "
                           f"{s.finish[i]:.6g}")
            if lst + tol < prev_lst or lft + tol < prev_lft:
                out.append(f"edge ({i},{j}) hop {k} ({l}): hop timing "
                           f"not monotone along the route")
            prev_lst, prev_lft = lst, lft
        if m.intervals and float(s.start[j]) + tol < m.intervals[-1][2]:
            out.append(f"edge ({i},{j}): successor starts "
                       f"{s.start[j]:.6g} before message arrives "
                       f"{m.intervals[-1][2]:.6g}")

    # --- link-contention exclusivity ---
    by_link: Dict[str, List[Tuple[float, float, Tuple[int, int]]]] = {}
    for e, m in s.messages.items():
        for (l, lst, lft) in m.intervals:
            by_link.setdefault(l, []).append((lst, lft, e))
    for l, ivs in by_link.items():
        ivs.sort()
        for (s0, f0, e0), (s1, f1, e1) in zip(ivs, ivs[1:]):
            if f0 > s1 + tol:
                out.append(f"link {l}: messages {e0} and {e1} overlap "
                           f"([{s0:.6g}, {f0:.6g}] vs "
                           f"[{s1:.6g}, {f1:.6g}])")
    return out


def validate_schedule(s: Schedule,
                      spec: Optional[FaultSpec] = None) -> None:
    """Raise :class:`ScheduleValidationError` on any violation."""
    v = schedule_violations(s, spec)
    if v:
        raise ScheduleValidationError(v)


# ----------------------------------------------------------------------
# Session-boundary input validation (actionable one-line ValueErrors)
# ----------------------------------------------------------------------
def _finite_positive(x, what: str) -> None:
    try:
        v = float(x)
    except (TypeError, ValueError):
        raise ValueError(f"{what} must be a number, got {x!r}") from None
    if math.isnan(v):
        raise ValueError(f"{what} is NaN")
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(f"{what} must be finite and > 0, got {v!r}")


def check_task_rates(task_rates: Dict[int, float], n: int) -> None:
    """Reject NaN/zero/negative rate factors and unknown task ids."""
    for t, f in task_rates.items():
        if not isinstance(t, (int, np.integer)) or isinstance(t, bool) \
                or not 0 <= int(t) < n:
            raise ValueError(f"unknown task id {t!r} (graph has tasks "
                             f"0..{n - 1})")
        _finite_positive(f, f"task_rates[{t}]")


def check_link_speeds(link_speed: Dict[str, float], tg: Topology) -> None:
    """Reject NaN/zero/negative speeds and unknown link names."""
    unknown = sorted(set(link_speed) - set(tg.link_speed))
    if unknown:
        raise ValueError(f"unknown links {unknown} (topology links: "
                         f"{tg.all_links()})")
    for l, sp in link_speed.items():
        _finite_positive(sp, f"link_speed[{l!r}]")


def check_graph(g: SPG) -> None:
    """Reject malformed SPGs at the session boundary.

    ``SPG.__post_init__`` already rejects cycles and bad edges at
    construction; this re-derives the cheap invariants so a graph that
    was mutated (or constructed around the dataclass machinery) still
    fails with an actionable message instead of a deep engine error.
    """
    if not isinstance(g, SPG):
        raise ValueError(f"submit expects an SPG, got {type(g).__name__}")
    if g.n <= 0:
        raise ValueError("graph has no tasks")
    if len(g.topo_order) != g.n:
        raise ValueError("graph is cyclic: no topological order covers "
                         "every task")
    w = np.asarray(g.weights, dtype=float)
    if w.shape != (g.n,):
        raise ValueError(f"weights shape {w.shape} != ({g.n},)")
    if np.isnan(w).any():
        raise ValueError(f"task weights contain NaN (tasks "
                         f"{np.flatnonzero(np.isnan(w)).tolist()})")
    if not np.isfinite(w).all() or (w < 0).any():
        bad = np.flatnonzero(~np.isfinite(w) | (w < 0)).tolist()
        raise ValueError(f"task weights must be finite and >= 0 (tasks "
                         f"{bad})")
    if g.comp_matrix is not None:
        cm = np.asarray(g.comp_matrix, dtype=float)
        if not np.isfinite(cm).all() or (cm < 0).any():
            raise ValueError("explicit comp_matrix entries must be "
                             "finite and >= 0")


def check_topology(tg: Topology) -> None:
    """Reject malformed topologies when a session is created."""
    rates = np.asarray(tg.rates, dtype=float)
    if rates.shape != (tg.n_procs,) or not np.isfinite(rates).all() \
            or (rates <= 0).any():
        raise ValueError("processor rates must be finite and > 0 "
                         "(one per processor)")
    for l, sp in tg.link_speed.items():
        _finite_positive(sp, f"link speed of {l!r}")
    known = set(tg.link_speed)
    for pair, rr in tg.routes.items():
        for r in rr:
            missing = [l for l in r if l not in known]
            if missing:
                raise ValueError(f"route {r} of pair {pair} uses "
                                 f"unknown links {missing}")

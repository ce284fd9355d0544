"""Candidate-evaluation backend protocol (the numeric layer of the engine).

Twin of ``repro.core.backends.base``.  :class:`~..engine.CompiledInstance`
is split in two:

  * the **decision layer** (``engine._run``) owns the priority-queue walk,
    precedence checks, decision-trace recording/resume, and ``Schedule``
    assembly — pure Python, identical for every backend;
  * the **numeric layer** (a :class:`CandidateEvaluator`) owns the
    per-task candidate evaluation over all ``P`` processors — the
    sequential message-routing walks (Eqs. 13-15), EST/EFT (Eqs. 10-12),
    the BP load-balance term (Def. 4.1), the selection value (Def. 4.2),
    winner selection, and the alpha crossing bound.

Committing a decision (:meth:`CandidateEvaluator.apply`) is shared
scalar code, identical floats in identical order whichever backend
produced the decision — which is what makes decision traces portable
between backends, and between this package and the reference.
"""
from __future__ import annotations

import abc
import time
from typing import ClassVar, List, Optional, Sequence, Tuple, TYPE_CHECKING

from ..faults import WaveTimeoutError

if TYPE_CHECKING:                                   # pragma: no cover
    from ..engine import CompiledInstance

__all__ = ["BackendCompatError", "CandidateEvaluator", "Decision"]

_INF = float("inf")

# What `evaluate` returns: the DecisionRecord tail plus the decision's
# alpha crossing-bound contribution (inf when not tracking):
#   (proc, est, eft, msgs, cand_A, cand_B, bound_contrib)
# with ``msgs`` = [(pred, route, [(link_id, lst, lft), ...]), ...].
Decision = Tuple[int, float, float, list, Optional[tuple], Optional[tuple],
                 float]


class BackendCompatError(ValueError):
    """The instance's topology cannot be expressed by this backend.

    Raised by :func:`~..backends.resolve_backend_name` when an explicit
    backend request is incompatible with the topology (so no session
    state is ever keyed for a plan that cannot be built), and
    defensively by backend constructors.
    """


class CandidateEvaluator(abc.ABC):
    """One candidate-evaluation backend bound to one compiled instance.

    Lifecycle per ``_run``: ``start(alpha, period, want_bound)`` resets
    the run state, then the engine hands the whole wave plan to
    :meth:`evaluate_plan` (or replays memoized records through
    :meth:`apply`).
    """

    name: ClassVar[str]

    def __init__(self, inst: "CompiledInstance") -> None:
        self.inst = inst

    # -------------------------------------------------------------- run
    def start(self, alpha: float, period: float, want_bound: bool) -> None:
        inst = self.inst
        self.alpha = alpha
        self.period = period
        self.want_bound = want_bound
        self.proc_of: List[int] = [-1] * inst.n
        self.ast: List[float] = [0.0] * inst.n
        self.aft: List[float] = [0.0] * inst.n
        self._alloc()

    @abc.abstractmethod
    def _alloc(self) -> None:
        """Allocate/reset ``link_free``, ``proc_free``, ``loads``."""

    @abc.abstractmethod
    def evaluate(self, j: int) -> Decision:
        """Evaluate all P placement candidates for task ``j`` against the
        current run state and pick the winner (Eqs. 10-15, Defs. 4.1-4.2).
        Does NOT mutate run state — the caller commits via :meth:`apply`.
        """

    def evaluate_batch(self, js: Sequence[int]) -> List[Decision]:
        """Evaluate-and-commit a wave of *independent* tasks, in order.

        Decisions inside a wave still interact through the shared
        link/processor state, so they are evaluated and committed
        sequentially; batching changes where the loop runs, never the
        decisions.  The default runs ``evaluate`` then :meth:`apply` per
        task; a device backend evaluates the wave in one launch.
        """
        decisions: List[Decision] = []
        for j in js:
            d = self.evaluate(j)
            self.apply(j, d[0], d[1], d[2], d[3])
            decisions.append(d)
        return decisions

    def evaluate_plan(self, waves: Sequence[Sequence[int]],
                      timeout: Optional[float] = None,
                      bid0: int = 0) -> List[List[Decision]]:
        """Evaluate-and-commit a whole **wave plan** (the full schedule).

        The default walks the plan wave by wave through
        :meth:`evaluate_batch`.  ``timeout`` is the engine's per-wave
        watchdog budget: an overrun raises
        :class:`~..faults.WaveTimeoutError` naming batch ``bid0 + k``.
        Returns one decision list per wave, in ``waves[k]`` order.
        """
        out: List[List[Decision]] = []
        for k, wave in enumerate(waves):
            if timeout is None:
                out.append(self.evaluate_batch(wave))
            else:
                t0 = time.monotonic()
                out.append(self.evaluate_batch(wave))
                elapsed = time.monotonic() - t0
                if elapsed > timeout:
                    raise WaveTimeoutError(bid0 + k, elapsed, timeout)
        return out

    # ------------------------------------------------------- fused sweep
    def supports_plan_sweep(self) -> bool:
        """Whether :meth:`evaluate_plan_sweep` evaluates a whole alpha
        grid in one dispatch.  Default: no — the session keeps the
        host-side per-alpha loop with interval skipping."""
        return False

    def evaluate_plan_sweep(self, waves: Sequence[Sequence[int]],
                            alphas: Sequence[float], period: float,
                            timeout: Optional[float] = None
                            ) -> List[List[List[Decision]]]:
        """Evaluate one wave plan under *every* alpha of a grid in one
        dispatch: ``[alpha][wave] -> decisions``, each alpha's decisions
        identical to an independent :meth:`evaluate_plan` run with bound
        tracking.  Must NOT commit to the run state."""
        raise NotImplementedError(
            f"backend {self.name!r} does not fuse alpha sweeps")

    # ------------------------------------------------------------ commit
    def apply(self, j: int, p: int, est: float, eft: float,
              msgs: list) -> None:
        """Commit one decision (fresh or replayed from a trace)."""
        self.proc_of[j] = p
        self.ast[j] = est
        self.aft[j] = eft
        self.proc_free[p] = eft
        self.loads[p] += self.inst._comp[j][p]
        link_free = self.link_free
        for (_i, _route, iv) in msgs:
            for (lid, _s, f) in iv:
                if f > link_free[lid]:
                    link_free[lid] = f

    # ------------------------------------------------------------- bound
    @staticmethod
    def crossing(p: int, cand_A: Sequence[float], cand_B: Sequence[float],
                 alpha: float) -> float:
        """Supremum-alpha contribution of one decision.

        For winner ``p`` with per-candidate linear selection values
        ``A_r + B_r * a``, returns the smallest rival crossing point
        ``(A_r - A_p) / (B_p - B_r)`` — or ``alpha`` itself when a rival
        is numerically indistinguishable — or ``inf`` when the winner
        keeps winning forever.
        """
        bound = _INF
        a_c, b_c = cand_A[p], cand_B[p]
        n = len(cand_A)
        for r in range(n):
            if r == p:
                continue
            d_b = b_c - cand_B[r]
            d_a = cand_A[r] - a_c
            scale = abs(a_c) + abs(cand_A[r]) + 1.0
            if d_b > 1e-15 * scale:
                a_star = d_a / d_b
                if a_star < bound:
                    bound = a_star
            elif abs(d_b) <= 1e-15 * scale and abs(d_a) <= 1e-12 * scale:
                if alpha < bound:
                    bound = alpha
        return bound

"""Scalar candidate-evaluation backend — the bit-exactness reference.

Twin of ``repro.core.backends.scalar``, line for line: flat Python
lists, sequential message-routing walks per candidate with
commit/rollback of the touched ``link_free`` entries, and scalar
EST/EFT/BP/selection arithmetic in the order of the reference
``list_schedule``.  The device backend (:mod:`.cuda`) is held
bit-identical to it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .base import CandidateEvaluator, Decision

_INF = float("inf")


class ScalarBackend(CandidateEvaluator):
    """Per-candidate scalar loop (the reference engine inner loop)."""

    name = "scalar"

    def _alloc(self) -> None:
        inst = self.inst
        self.link_free: List[float] = [0.0] * inst._n_links
        self.proc_free: List[float] = [0.0] * inst.P
        self.loads: List[float] = [0.0] * inst.P
        self._cand_A = [0.0] * inst.P
        self._cand_B = [0.0] * inst.P

    def evaluate(self, j: int) -> Decision:
        inst = self.inst
        P = inst.P
        comp = inst._comp
        ldet = inst._ldet
        msg_plans = inst._msg_plans
        msg_plans_for = inst.msg_plans_for
        link_free = self.link_free
        proc_free = self.proc_free
        loads = self.loads
        proc_of = self.proc_of
        aft = self.aft
        alpha = self.alpha
        period = self.period
        cand_A = self._cand_A
        cand_B = self._cand_B

        order = sorted(inst._preds[j], key=lambda i: (aft[i], i))
        comp_j = comp[j]
        ldet_j = ldet[j]
        exit_j = inst._is_exit[j]
        track = self.want_bound and not exit_j
        best_value = best_eft = 0.0
        best_est = 0.0
        best_p = -1
        best_msgs: List[Tuple[int, Tuple[str, ...],
                              List[Tuple[int, float, float]]]] = []

        for p in range(P):
            arrival = 0.0
            msgs: List[Tuple[int, Tuple[str, ...],
                             List[Tuple[int, float, float]]]] = []
            touched: List[Tuple[int, float]] = []
            for i in order:
                src = proc_of[i]
                if src == p:
                    if aft[i] > arrival:
                        arrival = aft[i]
                    continue
                aft_i = aft[i]
                plans = msg_plans.get((i, j, src, p))
                if plans is None:
                    plans = msg_plans_for(i, j, src, p)      # Eq. 15
                # --- best route src -> p (Eqs. 13-15) ---
                bk0, bk1, bk2 = _INF, 0, 0
                best_iv: Optional[List[Tuple[int, float, float]]] = None
                best_route: Tuple[str, ...] = ()
                for ridx, (lids, cts, robj) in enumerate(plans):
                    iv: List[Tuple[int, float, float]] = []
                    first = True
                    lst = 0.0
                    lft = 0.0
                    for h in range(len(lids)):
                        lid = lids[h]
                        avail = link_free[lid]
                        if first:
                            lst = aft_i if aft_i > avail else avail
                            first = False
                        else:
                            lst = lst if lst > avail else avail
                        x = lst + cts[h]
                        lft = lft if lft > x else x          # Eq. 14
                        iv.append((lid, lst, lft))
                    nh = len(lids)
                    if lft < bk0 or (lft == bk0 and
                                     (nh < bk1 or (nh == bk1 and
                                                   ridx < bk2))):
                        bk0, bk1, bk2 = lft, nh, ridx
                        best_iv = iv
                        best_route = robj
                assert best_iv is not None
                for (lid, _s, f) in best_iv:
                    old = link_free[lid]
                    touched.append((lid, old))
                    if f > old:
                        link_free[lid] = f
                msgs.append((i, best_route, best_iv))
                if bk0 > arrival:
                    arrival = bk0
            pf = proc_free[p]
            est = pf if pf > arrival else arrival            # Eqs. 10-11
            eft = est + comp_j[p]                            # Eq. 12
            if exit_j:
                value = eft                                  # Def. 4.2
            else:
                bp = 1.0 + (loads[p] / period) * alpha       # Def. 4.1
                value = eft * ldet_j[p] * bp
            for lid, old in reversed(touched):
                link_free[lid] = old
            if track:
                a_p = eft * ldet_j[p]
                cand_A[p] = a_p
                cand_B[p] = a_p * (loads[p] / period)
            if best_p < 0 or value < best_value or \
                    (value == best_value and eft < best_eft):
                # strict lexicographic (value, eft, proc): p ascends,
                # so an exact (value, eft) tie keeps the earlier proc
                best_value, best_eft, best_est = value, eft, est
                best_p, best_msgs = p, msgs

        if track:
            ca, cb = tuple(cand_A), tuple(cand_B)
            contrib = self.crossing(best_p, ca, cb, alpha)
        else:
            ca = cb = None
            contrib = _INF
        return best_p, best_est, best_eft, best_msgs, ca, cb, contrib

"""Vectorized candidate-evaluation backend: (P,)-batch NumPy array ops.

Twin of ``repro.core.backends.vector``.  Evaluates all ``P`` placement
candidates of one dequeued task at once, on the host.  The
per-candidate tentative link state lives in one flat ``(P*L + 2,)``
buffer — lane ``p`` owns slots ``[p*L, (p+1)*L)``, a *sink* slot absorbs
writes that the scalar path would not perform (same-processor
predecessors, hop padding), and a read-only ``-inf`` slot feeds reads
that must not constrain a start time.  Rollback is free: lanes never
alias, and committing the winner is the shared scalar
:meth:`~.base.CandidateEvaluator.apply`.

The message-routing recurrences (Eqs. 13-14) are running maxima, and
``max`` is exact in IEEE-754, so

    LST_h = max(aft_i, avail_0, ..., avail_h)
    LFT_h = max(x_0, ..., x_h),  x_h = LST_h + CTML_h

reassociate without changing a bit; each hop is one ``(P,)`` row op.
Committing a route needs no read-back: ``LFT_h >= avail_h`` (CTML >= 0),
so the scalar path's ``if f > old`` write is a plain scatter.  Every
inexact operation (adds, multiplies, divides, comparisons) is performed
elementwise in the reference's operand order, which keeps this backend
bit-identical to :class:`~.scalar.ScalarBackend` and to the reference's
vector backend (``tests/test_torch_vector.py``).

Per-lane BP terms are cached incrementally: ``loads[p]`` changes only
when a decision commits, so ``apply`` refreshes ``loads[p]/period`` and
``1 + (loads[p]/period)*alpha`` for the winner lane alone.

The regime is small arrays (P*H is tens of elements), where per-call
dispatch dominates: this backend stays in NumPy, whose ufunc call costs
a fraction of an eager ``torch`` CPU op.  Winner selection runs on
``.tolist()`` floats (exact), and single-predecessor tasks gather
straight from the committed link state.

Routes come from the shared :mod:`.layout` precompute (``src_layout``,
``ensure_ct_table``); this module adds the lane-buffer gather and
scatter indices of each source's layout.  The ``src`` lane's fake
zero-CTML route gives a final LFT of exactly ``aft_i``, the scalar
path's same-processor arrival.

Requires every route to visit each link at most once;
:func:`~..backends.resolve_backend_name` rejects an explicit
``backend="vector"`` on such a topology up front, and ``"auto"`` picks
the scalar backend there.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .base import BackendCompatError, CandidateEvaluator, Decision
from .layout import SrcLayout, ensure_ct_table, src_layout

__all__ = ["VectorBackend"]

_INF = float("inf")
_NEG_INF = float("-inf")


class _Lanes:
    """Lane-buffer indices of one source's :class:`~.layout.SrcLayout`:
    ``read_idx`` / ``write_idx`` ``(P, R, H)`` into the ``(P*L + 2,)``
    buffer (padding reads the ``-inf`` slot, writes the sink), and the
    hop-major single-route forms ``av_idx``, ``base_flat`` (into the
    committed ``(L + 1,)`` state, slot ``L`` = ``-inf``) and ``w_rows``."""

    __slots__ = ("read_idx", "write_idx", "has_invalid", "av_idx",
                 "base_flat", "w_rows")

    def __init__(self, lay: SrcLayout) -> None:
        P, L = lay.P, lay.L
        real = lay.lid >= 0
        lane = np.arange(P, dtype=np.intp)[:, None, None] * L + lay.lid
        self.read_idx = np.where(real, lane, P * L + 1).astype(np.intp)
        self.write_idx = np.where(real, lane, P * L).astype(np.intp)
        base_idx = np.where(real, lay.lid, L).astype(np.intp)
        self.has_invalid = bool(lay.invalid.any())
        self.av_idx = np.ascontiguousarray(self.read_idx[:, 0, :].T).ravel()
        self.base_flat = np.ascontiguousarray(base_idx[:, 0, :].T).ravel()
        self.w_rows = [np.ascontiguousarray(self.write_idx[:, 0, h])
                       for h in range(lay.H)]


class VectorBackend(CandidateEvaluator):
    """(P,)-batch candidate evaluation on NumPy arrays."""

    name = "vector"

    def __init__(self, inst) -> None:
        super().__init__(inst)
        for pair, rr in inst._routes.items():
            for (lids, _spds, _robj) in rr:
                if len(set(lids)) != len(lids):
                    raise BackendCompatError(
                        f"route {pair} visits a link twice; the vector "
                        "backend's batched scatter needs link-disjoint "
                        "routes — use backend='scalar'")
        P, L = inst.P, inst._n_links
        self._L = L
        self._sink = P * L
        self._neg = P * L + 1
        self._tent = np.empty(P * L + 2, dtype=np.float64)
        self._tent2d = self._tent[:P * L].reshape(P, L)
        self._tent[self._sink] = 0.0         # write-only garbage slot
        self._tent[self._neg] = _NEG_INF     # read-only, never written
        # src -> (layout, its lane indices)
        self._lanes: Dict[int, Tuple[SrcLayout, _Lanes]] = {}

    def _alloc(self) -> None:
        inst = self.inst
        P, L = inst.P, self._L
        # committed link state, with a trailing read-only -inf slot so
        # single-pred gathers can use it directly
        self.link_free = np.zeros(L + 1, dtype=np.float64)
        self.link_free[L] = _NEG_INF
        self._lf = self.link_free[:L]
        self.proc_free = np.zeros(P, dtype=np.float64)
        self.loads = np.zeros(P, dtype=np.float64)
        # incrementally maintained Def.-4.1 terms (see apply)
        self._lop = np.zeros(P, dtype=np.float64)
        self._bp = np.ones(P, dtype=np.float64)

    def apply(self, j: int, p: int, est: float, eft: float,
              msgs: list) -> None:
        super().apply(j, p, est, eft, msgs)
        # only the winner lane's load changed; refresh its BP terms with
        # the exact scalar expressions the reference uses per candidate
        lop = self.loads[p] / self.period
        self._lop[p] = lop
        self._bp[p] = 1.0 + lop * self.alpha

    def _layout(self, src: int) -> Tuple[SrcLayout, _Lanes]:
        lay = src_layout(self.inst, src)
        got = (lay, _Lanes(lay))
        self._lanes[src] = got
        return got

    # ------------------------------------------------------------------
    def evaluate(self, j: int) -> Decision:
        inst = self.inst
        P = inst.P
        aft = self.aft
        proc_of = self.proc_of
        tent = self._tent
        lanes = self._lanes
        edge_index = inst._edge_index
        maximum = np.maximum

        preds = inst._preds[j]
        n_preds = len(preds)
        if n_preds > 1:
            preds = sorted(preds, key=lambda i: (aft[i], i))
            np.copyto(self._tent2d, self._lf)    # every lane: base state
        tent_ready = n_preds > 1
        last = n_preds - 1
        finals = []
        walks: List[tuple] = []                  # winner-lane msgs data
        for k in range(n_preds):
            i = preds[k]
            src = proc_of[i]
            aft_i = aft[i]
            got = lanes.get(src)
            lay, ix = got if got is not None else self._layout(src)
            ct = lay.ct_table
            if ct is None:
                ct = ensure_ct_table(inst, lay)
            ct = ct[edge_index[(i, j)]]
            if lay.R == 1:
                if tent_ready:
                    av = tent.take(ix.av_idx)
                else:                            # single pred: read the
                    av = self.link_free.take(ix.base_flat)  # base directly
                commit = k < last                # last pred: no readers
                lst_rows = []
                lft_rows = []
                lst = lft = None
                for h in range(lay.H):
                    avh = av[h * P:(h + 1) * P]
                    lst = maximum(avh, aft_i) if h == 0 \
                        else maximum(avh, lst)   # Eq. 13, reassociated
                    x = lst + ct[h]              # hop-major table row
                    lft = x if h == 0 else maximum(lft, x)   # Eq. 14
                    if commit:
                        # LFT_h >= avail_h always: plain scatter commit
                        tent[ix.w_rows[h]] = lft
                    lst_rows.append(lst)
                    lft_rows.append(lft)
                finals.append(lft)
                walks.append((i, src, lay, lst_rows, lft_rows, None))
                continue
            # ---- multi-route general path ----
            if not tent_ready:
                np.copyto(self._tent2d, self._lf)
                tent_ready = True
            avail = tent[ix.read_idx]            # (P, R, H) gather
            lst3 = np.maximum.accumulate(avail, axis=2)
            lst3 = maximum(lst3, aft_i)
            lft3 = np.maximum.accumulate(lst3 + ct, axis=2)
            final = lft3[:, :, -1]               # (P, R) route arrivals
            if ix.has_invalid:
                final = np.where(lay.invalid, _INF, final)
            # lexicographic (LFT, hops, route-index) min per lane
            nhops = lay.nhops
            best_f = final[:, 0].copy()
            best_nh = nhops[:, 0].copy()
            best_r = np.zeros(P, dtype=np.intp)
            for r in range(1, lay.R):
                f = final[:, r]
                better = (f < best_f) | ((f == best_f) &
                                         (nhops[:, r] < best_nh))
                np.copyto(best_f, f, where=better)
                np.copyto(best_nh, nhops[:, r], where=better)
                best_r[better] = r
            sel = best_r[:, None, None]
            lft_sel = np.take_along_axis(lft3, sel, axis=1)[:, 0, :]
            wi = np.take_along_axis(ix.write_idx, sel,
                                    axis=1)[:, 0, :].ravel()
            tent[wi] = lft_sel.ravel()
            finals.append(best_f)
            walks.append((i, src, lay, lst3, lft3, best_r))

        # ---- batched Eqs. 10-12 + Defs. 4.1-4.2 over all P lanes ----
        if not finals:
            est = self.proc_free                 # arrival == 0 <= proc_free
        elif n_preds == 1:
            est = maximum(self.proc_free, finals[0])
        else:
            acc = maximum(finals[0], finals[1])
            for f in finals[2:]:
                acc = maximum(acc, f)
            est = maximum(acc, self.proc_free)   # Eqs. 10-11, reassociated
        eft = est + inst.comp[j]                 # Eq. 12
        exit_j = inst._is_exit[j]
        track = self.want_bound and not exit_j
        if exit_j:
            A = None
            value = eft                          # Def. 4.2
        else:
            A = eft * inst.ldet[j]
            value = A * self._bp                 # Def. 4.1 (cached BP)

        # strict lexicographic (value, eft, proc) argmin, first-index
        # ties — on exact tolist floats, matching the scalar loop
        vl = value.tolist()
        el = eft.tolist()
        p = 0
        bv = vl[0]
        be = el[0]
        for q in range(1, P):
            v = vl[q]
            if v < bv or (v == bv and el[q] < be):
                p, bv, be = q, v, el[q]

        msgs = []
        for (i, src, lay, lst_w, lft_w, best_r) in walks:
            if src == p:
                continue
            if best_r is None:                   # hop-major rows
                lids, robj = lay.route_meta[p][0]
                msgs.append((i, robj,
                             [(lids[h], float(lst_w[h][p]),
                               float(lft_w[h][p]))
                              for h in range(len(lids))]))
            else:
                r = int(best_r[p])
                lids, robj = lay.route_meta[p][r]
                msgs.append((i, robj,
                             [(lids[h], float(lst_w[p, r, h]),
                               float(lft_w[p, r, h]))
                              for h in range(len(lids))]))

        if track:
            B = A * self._lop
            contrib = self._crossing_vec(p, A, B)
            ca, cb = tuple(A.tolist()), tuple(B.tolist())
        else:
            ca = cb = None
            contrib = _INF
        return p, float(est[p]), be, msgs, ca, cb, contrib

    # ------------------------------------------------------------------
    def _crossing_vec(self, p: int, A: np.ndarray, B: np.ndarray) -> float:
        """Vectorized :meth:`~.base.CandidateEvaluator.crossing`: the same
        divisions on the same operands, and ``min`` is order-free, so the
        returned float is the scalar rival loop's."""
        d_b = B[p] - B
        d_a = A - A[p]
        scale = np.abs(A) + abs(A[p])
        scale += 1.0
        thr = 1e-15 * scale
        mask1 = d_b > thr
        contrib = _INF
        if mask1.any():
            a_star = d_a / np.where(mask1, d_b, 1.0)
            contrib = float(np.where(mask1, a_star, _INF).min())
        mask2 = (np.abs(d_b) <= thr) & (np.abs(d_a) <= 1e-12 * scale)
        mask2[p] = False                 # the scalar loop skips the winner
        if mask2.any() and self.alpha < contrib:
            contrib = self.alpha
        return contrib

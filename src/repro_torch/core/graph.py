"""Stream Processing Graph (SPG) — Definition 2.2 of the paper.

An SPG is a DAG ``G = <V(G), E(G)>`` whose nodes are stream operators (tasks)
with a computational volume ``w_i`` and whose edges carry a communication
volume ``tpl(e_ij)`` (a tuple batch).  The paper's worked example (Fig. 3,
Table 1) ships as :func:`paper_spg`.

Twin of ``repro.core.graph``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


@dataclasses.dataclass
class SPG:
    """Directed acyclic stream-processing graph.

    Nodes are ``0..n-1`` (the paper's ``n1`` is node ``0``).  ``weights[i]``
    is the computational volume ``w_i`` (Definition 2.1).  ``tpl[(i, j)]`` is
    the communication volume of edge ``e_{i,j}``; when
    ``tpl_proportional_ccr`` is set instead, the worked-example convention of
    the paper is used: ``tpl(e_ij | p_src) = CCR * comp(n_i, p_src)`` (this is
    the only convention that reproduces Table 2 of the paper exactly).
    """

    n: int
    edges: List[Edge]
    weights: np.ndarray
    tpl: Dict[Edge, float] = dataclasses.field(default_factory=dict)
    tpl_proportional_ccr: Optional[float] = None
    # Optional explicit per-processor computation-time matrix (n x p).  When
    # given it overrides ``weights / rate`` (the paper's tables are rounded,
    # so exact reproduction needs the table itself).
    comp_matrix: Optional[np.ndarray] = None
    name: str = "spg"

    def __post_init__(self) -> None:
        self.weights = np.asarray(self.weights, dtype=float)
        if self.weights.shape != (self.n,):
            raise ValueError(f"weights must have shape ({self.n},)")
        self.succ: List[List[int]] = [[] for _ in range(self.n)]
        self.pred: List[List[int]] = [[] for _ in range(self.n)]
        seen = set()
        for (i, j) in self.edges:
            if not (0 <= i < self.n and 0 <= j < self.n):
                raise ValueError(f"edge ({i},{j}) out of range")
            if (i, j) in seen:
                raise ValueError(f"duplicate edge ({i},{j})")
            seen.add((i, j))
            self.succ[i].append(j)
            self.pred[j].append(i)
        self._topo = self._toposort()
        self.depth = self._depths()
        self._comp_cache: Dict[bytes, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _toposort(self) -> List[int]:
        indeg = [len(self.pred[i]) for i in range(self.n)]
        stack = [i for i in range(self.n) if indeg[i] == 0]
        order: List[int] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in self.succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != self.n:
            raise ValueError("graph has a cycle")
        return order

    def _depths(self) -> np.ndarray:
        """Paper depth: 1 + length of the longest entry->node path."""
        depth = np.ones(self.n, dtype=int)
        for u in self._topo:
            for v in self.succ[u]:
                depth[v] = max(depth[v], depth[u] + 1)
        return depth

    # ------------------------------------------------------------------
    @property
    def topo_order(self) -> List[int]:
        return list(self._topo)

    def outd(self, i: int) -> int:
        return len(self.succ[i])

    def ind(self, i: int) -> int:
        return len(self.pred[i])

    @property
    def entries(self) -> List[int]:
        return [i for i in range(self.n) if not self.pred[i]]

    @property
    def exits(self) -> List[int]:
        return [i for i in range(self.n) if not self.succ[i]]

    @property
    def max_outd(self) -> int:
        return max(len(s) for s in self.succ)

    # ------------------------------------------------------------------
    def comp(self, i: int, pu: int, rates: Sequence[float]) -> float:
        """Computation time of task ``i`` on processor ``pu`` (Eq. 1)."""
        if self.comp_matrix is not None:
            return float(self.comp_matrix[i, pu])
        return float(self.weights[i]) / float(rates[pu])

    def comp_matrix_for(self, rates: Sequence[float]) -> np.ndarray:
        """Cached ``(n, P)`` computation-time matrix for a rate vector.

        Entry ``[i, p]`` is bit-identical to ``comp(i, p, rates)`` — the
        compiled engine and the vectorized rank computation index this array
        instead of calling :meth:`comp` per scalar.
        """
        rates_arr = np.asarray(rates, dtype=float)
        # with an explicit matrix the rates are ignored (Eq. 1 override)
        key = b"" if self.comp_matrix is not None else rates_arr.tobytes()
        cached = self._comp_cache.get(key)
        if cached is None:
            if len(self._comp_cache) >= 8:
                # replan loops feed continuously drifting measured rates;
                # rebuilding is cheap, so cap the cache instead of leaking
                self._comp_cache.clear()
            if self.comp_matrix is not None:
                cached = np.asarray(self.comp_matrix, dtype=float).copy()
            else:
                cached = self.weights[:, None] / rates_arr[None, :]
            cached.setflags(write=False)
            self._comp_cache[key] = cached
        return cached

    def comm_volume(self, i: int, j: int, comp_src: float) -> float:
        """Communication volume ``tpl(e_ij)``.

        ``comp_src`` is ``comp(n_i, p_src)`` — used only by the paper's
        worked-example convention (tpl proportional to the source task's
        computation time, scaled by CCR).
        """
        if self.tpl_proportional_ccr is not None:
            return self.tpl_proportional_ccr * comp_src
        return float(self.tpl[(i, j)])

    def default_period(self, rates: Sequence[float], n_procs: int) -> float:
        """Sum of per-task minimum computation times — the Definition-4.1
        application-period proxy used when no explicit period is given.

        Single source of truth for the reference scheduler, the compiled
        engine, and the session API: the engine/reference bit-identity
        guarantee for ``period=None`` depends on all of them summing the
        same floats in the same order.
        """
        comp = self.comp_matrix_for(rates)[:, :n_procs]
        return float(sum(min(row) for row in comp.tolist()))

    def critical_path_min_comp(self, rates: Sequence[float],
                               n_procs: int) -> float:
        """Denominator of SLR (Eq. 22): the min-computation critical path."""
        best = np.zeros(self.n)
        for u in reversed(self._topo):
            c = min(self.comp(u, p, rates) for p in range(n_procs))
            tail = max((best[v] for v in self.succ[u]), default=0.0)
            best[u] = c + tail
        return float(max(best[e] for e in self.entries))


# ----------------------------------------------------------------------
# The paper's worked example (Fig. 3 / Tables 1-2).
# Edge set reverse-engineered from the paper and verified against every rank
# value of Table 2 (see tests/test_paper_example.py):
#   pred(n5) = {n1,n2,n3}; succ(n5) = {n7,n8}; e(3,6); e(6,9); e(8,9);
#   e(7,10); succ(n1) = succ(n2) = {n4,n5}; succ(n4) = {n7,n8}.
PAPER_EDGES: List[Edge] = [
    (0, 3), (0, 4),          # n1 -> n4, n5
    (1, 3), (1, 4),          # n2 -> n4, n5
    (2, 4), (2, 5),          # n3 -> n5, n6
    (3, 6), (3, 7),          # n4 -> n7, n8
    (4, 6), (4, 7),          # n5 -> n7, n8
    (5, 8),                  # n6 -> n9
    (6, 9),                  # n7 -> n10
    (7, 8),                  # n8 -> n9
]

# Table 1 computation-time matrix (tasks x processors p1,p2,p3).
PAPER_COMP = np.array([
    [18, 12, 14],
    [12, 8, 10],
    [12, 8, 10],
    [21, 14, 17],
    [9, 6, 7],
    [15, 10, 12],
    [26, 17, 20],
    [14, 9, 11],
    [20, 13, 16],
    [15, 10, 12],
], dtype=float)

# Table 4 computation-time matrix (Experiment 5).
PAPER_COMP_EXP5 = np.array([
    [26, 17, 20],
    [26, 17, 20],
    [14, 9, 11],
    [12, 8, 10],
    [17, 11, 13],
    [30, 20, 24],
    [9, 6, 7],
    [27, 18, 22],
    [27, 18, 22],
    [30, 20, 24],
], dtype=float)


def paper_spg(ccr: float = 1.0, comp: Optional[np.ndarray] = None) -> SPG:
    """Fig. 3 SPG with Table 1 times (or a supplied matrix, e.g. Table 4)."""
    comp = PAPER_COMP if comp is None else comp
    # weights w_i such that comp on p2 (rate 1.0) equals the table.
    return SPG(
        n=10,
        edges=list(PAPER_EDGES),
        weights=comp[:, 1].copy(),
        tpl_proportional_ccr=ccr,
        comp_matrix=comp.copy(),
        name="paper_fig3",
    )

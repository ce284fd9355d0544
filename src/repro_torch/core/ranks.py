"""Task-prioritizing phase: per-processor ranks and HPRV values (Section 4.1).

Unlike HEFT-style averaging, the rank of Eq. 2 is computed *per source
processor* using that processor's data-transfer speed (Eq. 5/6), which is
what makes the priorities accurate on heterogeneous networks.

Twin of ``repro.core.ranks``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .graph import SPG
from .topology import Topology


def rank_matrix_reference(g: SPG, tg: Topology) -> np.ndarray:
    """Scalar-loop reference for :func:`rank_matrix` (kept for the
    engine-equivalence tests; bit-identical to the vectorized path)."""
    P = tg.n_procs
    rank = np.zeros((g.n, P))
    speeds = np.array([tg.proc_speed(p) for p in range(P)])
    for u in reversed(g.topo_order):
        for p in range(P):
            c = g.comp(u, p, tg.rates)
            if not g.succ[u]:
                rank[u, p] = c
                continue
            best = 0.0
            for v in g.succ[u]:
                tpl = g.comm_volume(u, v, c)
                comm = tpl / speeds[p]           # Eq. 6
                best = max(best, rank[v, p] + comm)
            rank[u, p] = c + best
    return rank


def rank_matrix(g: SPG, tg: Topology) -> np.ndarray:
    """``rank(n_i, p_src)`` for every task/processor pair (Eq. 2).

    Returns an (n_tasks, n_procs) array.  Computed as a level sweep: nodes
    are grouped by height (longest path to an exit) and each level's ranks
    come from one batched gather + masked max over the padded successor
    table.  Every elementwise op (tpl scaling, the Eq. 6 division, the
    final max/add) matches the scalar reference op-for-op, so the result
    is bit-identical to :func:`rank_matrix_reference`.
    """
    P = tg.n_procs
    n = g.n
    comp = g.comp_matrix_for(tg.rates)
    speeds = np.array([tg.proc_speed(p) for p in range(P)])
    rank = np.zeros((n, P))

    # height = longest path to an exit; nodes at the same height have all
    # successors strictly below, so a level can be computed in one batch.
    height = np.zeros(n, dtype=int)
    for u in reversed(g.topo_order):
        for v in g.succ[u]:
            if height[v] + 1 > height[u]:
                height[u] = height[v] + 1
    levels: List[List[int]] = [[] for _ in range(int(height.max()) + 1)]
    for u in range(n):
        levels[height[u]].append(u)

    exits = np.array(levels[0], dtype=int)
    rank[exits] = comp[exits]
    ccr = g.tpl_proportional_ccr
    for lvl in levels[1:]:
        nodes = np.array(lvl, dtype=int)
        m = max(len(g.succ[u]) for u in lvl)
        succ_pad = np.zeros((len(lvl), m), dtype=int)
        mask = np.zeros((len(lvl), m), dtype=bool)
        for r_, u in enumerate(lvl):
            su = g.succ[u]
            succ_pad[r_, :len(su)] = su
            mask[r_, :len(su)] = True
        gathered = rank[succ_pad]                        # (k, m, P)
        if ccr is not None:
            # tpl(e_uv | p) = CCR * comp(u, p): same for every successor
            comm = (ccr * comp[nodes]) / speeds          # (k, P), Eq. 6
            contrib = gathered + comm[:, None, :]
        else:
            tpl_pad = np.zeros((len(lvl), m))
            for r_, u in enumerate(lvl):
                for c_, v in enumerate(g.succ[u]):
                    tpl_pad[r_, c_] = g.tpl[(u, v)]
            comm = tpl_pad[:, :, None] / speeds[None, None, :]
            contrib = gathered + comm
        contrib = np.where(mask[:, :, None], contrib, -np.inf)
        best = np.maximum(contrib.max(axis=1), 0.0)      # reference init 0.0
        rank[nodes] = comp[nodes] + best
    return rank


def hrank(g: SPG, tg: Topology, rank: np.ndarray | None = None) -> np.ndarray:
    """Average rank over all processors (Eq. 7)."""
    rank = rank_matrix(g, tg) if rank is None else rank
    return rank.mean(axis=1)


def hprv_a(g: SPG, tg: Topology, rank: np.ndarray | None = None) -> np.ndarray:
    """HPRV_CC (A): ``hrank * outd`` (Eq. 8) — the HSV_CC prioritizer."""
    h = hrank(g, tg, rank)
    outd = np.array([g.outd(i) for i in range(g.n)], dtype=float)
    return h * outd


def hprv_b(g: SPG, tg: Topology, rank: np.ndarray | None = None,
           depth_power: int = 2, outd_mode: str = "indicator") -> np.ndarray:
    """HPRV_CC (B): the depth-damped prioritizer (Eq. 9).

    ``outd_mode="indicator"`` (default) treats the out-degree factor as a
    presence indicator (exit tasks 0, everything else 1), i.e.
    ``HPRV = hrank / depth**k``.  This is what the paper's own Table 2
    evaluates (n6: 38.6/4 = 9.7, n7: 50.2/9 = 5.6 — the printed values
    carry *no* outd/max_outd factor for outd=1 nodes), and it makes the
    paper's Experiment-4 headline (SFR = 0%) a theorem:

      For every edge (p, s): rank(p, u) >= comp(p, u) + rank(s, u) +
      comm > rank(s, u) on every processor u, hence hrank(p) > hrank(s);
      and depth(p) < depth(s).  Therefore HPRV(p) > HPRV(s) strictly for
      any depth_power >= 1 — a successor can never be dequeued before its
      predecessor.

    ``outd_mode="literal"`` is Eq. 9 exactly as printed
    (``hrank * outd/max_outd / depth**k``); it reproduces the paper's
    depth^1 ablation (~29% SFR) but retains a small failure rate even at
    k=2 (see DESIGN.md §9 for the contradiction in the paper).
    ``depth_power=1`` reproduces the HVLB_CC(depth) ablation.
    """
    h = hrank(g, tg, rank)
    outd = np.array([g.outd(i) for i in range(g.n)], dtype=float)
    if outd_mode == "indicator":
        factor = (outd > 0).astype(float)
    elif outd_mode == "literal":
        factor = outd / (float(g.max_outd) or 1.0)
    else:
        raise ValueError(f"unknown outd_mode {outd_mode!r}")
    return h * factor / (g.depth.astype(float) ** depth_power)


def ldet_cc(g: SPG, tg: Topology, rank: np.ndarray | None = None) -> np.ndarray:
    """Longest-distance exit time (Eq. 16): ``rank - comp``; 1.0 for exits."""
    rank = rank_matrix(g, tg) if rank is None else rank
    out = rank - g.comp_matrix_for(tg.rates)
    exits = [i for i in range(g.n) if not g.succ[i]]
    out[exits] = 1.0
    return out


def priority_queue(values: np.ndarray, h: np.ndarray) -> List[int]:
    """Non-increasing HPRV order; ties broken by hrank, then node index.

    Reproduces the paper's queues for Fig. 3 (A: n1,n2,n3,n4,n5,n7,n6,n8,
    n9,n10 — note the n3/n4 HPRV tie resolved by index; B: n1..n10).
    """
    return sorted(range(len(values)),
                  key=lambda i: (-round(values[i], 6), -round(h[i], 6), i))

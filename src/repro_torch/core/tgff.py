"""TGFF-style random stream-processing-graph generator (Section 5.2).

Parameters follow the paper: max in-degree 2, max out-degree 3, at least two
entry and two exit nodes, task weights drawn so per-processor computation
times vary with the execution rates, and edge communication volumes scaled
to a target CCR (communication-to-computation ratio).

``outdeg_constraint=True`` additionally enforces ``outd(pred) >= outd(succ)``
— the restricted family that HSV_CC can always schedule (used by
Experiments 1-3); Experiment 4 turns it off to measure SFR.

Twin of ``repro.core.tgff``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import SPG
from .topology import Topology


def random_spg(n: int, rng: np.random.Generator, *, max_in: int = 2,
               max_out: int = 3, min_entries: int = 2, min_exits: int = 2,
               ccr: float = 1.0, tg: Optional[Topology] = None,
               outdeg_constraint: bool = False,
               w_lo: float = 5.0, w_hi: float = 25.0) -> SPG:
    """Random layered DAG with the paper's degree constraints."""
    for _attempt in range(200):
        g = _try_random(n, rng, max_in, max_out, min_entries, min_exits)
        if g is None:
            continue
        edges, depth_ok = g
        if outdeg_constraint:
            edges = _enforce_outdeg(n, edges)
            if edges is None or not _check_outdeg(n, edges):
                continue
        weights = rng.uniform(w_lo, w_hi, size=n)
        spg = SPG(n=n, edges=edges, weights=weights, name=f"tgff_{n}")
        _assign_tpl(spg, rng, ccr, tg)
        return spg
    raise RuntimeError("could not generate a graph with the constraints")


def _try_random(n, rng, max_in, max_out, min_entries, min_exits):
    n_levels = max(2, int(round(np.sqrt(n))) + rng.integers(0, 2))
    levels = np.sort(rng.integers(0, n_levels, size=n))
    levels[:min_entries] = 0                      # guarantee entries
    levels[-min_exits:] = n_levels - 1            # guarantee exits
    edges = []
    ind = np.zeros(n, dtype=int)
    outd = np.zeros(n, dtype=int)
    order = np.arange(n)
    for j in order:
        if levels[j] == 0:
            continue
        cands = [i for i in order
                 if levels[i] < levels[j] and outd[i] < max_out]
        if not cands:
            return None
        k = int(rng.integers(1, max_in + 1))
        k = min(k, len(cands))
        for i in rng.choice(cands, size=k, replace=False):
            edges.append((int(i), int(j)))
            ind[j] += 1
            outd[i] += 1
    # every non-exit node must reach somewhere: attach dangling nodes
    for i in order:
        if levels[i] < levels.max() and outd[i] == 0:
            cands = [j for j in order
                     if levels[j] > levels[i] and ind[j] < max_in]
            if cands:
                j = int(rng.choice(cands))
                edges.append((int(i), j))
                ind[j] += 1
                outd[i] += 1
                continue
            # Every later node is at full in-degree (common once n is in
            # the hundreds: earlier repairs saturate the scarce top
            # levels).  Steal an in-slot from a predecessor that can spare
            # an out-edge — every degree cap is preserved.
            swaps = [(ii, j) for (ii, j) in edges
                     if levels[j] > levels[i] and outd[ii] > 1]
            if not swaps:
                return None
            ii, j = swaps[int(rng.integers(len(swaps)))]
            edges.remove((ii, j))
            outd[ii] -= 1
            edges.append((int(i), int(j)))
            outd[i] += 1
    return edges, True


def _enforce_outdeg(n, edges):
    """Repair pass: drop out-edges of violating successors until
    ``outd(pred) >= outd(succ)`` holds on every edge (Experiment 1-3
    graph family).  Edges are only removed when the sink keeps ind >= 1."""
    edges = list(edges)
    for _ in range(10 * len(edges) + 10):
        outd = np.zeros(n, dtype=int)
        ind = np.zeros(n, dtype=int)
        for (i, j) in edges:
            outd[i] += 1
            ind[j] += 1
        bad = [(i, j) for (i, j) in edges if outd[i] < outd[j]]
        if not bad:
            return edges
        bad.sort(key=lambda e: outd[e[1]] - outd[e[0]], reverse=True)
        i, j = bad[0]
        # shrink outd(j): remove one of j's out-edges whose sink keeps ind>1
        cands = [(jj, k) for (jj, k) in edges if jj == j and ind[k] > 1]
        if cands:
            cands.sort(key=lambda e: -ind[e[1]])
            edges.remove(cands[0])
        elif ind[j] > 1:
            edges.remove((i, j))
        else:
            return None
    return None


def _check_outdeg(n, edges):
    outd = np.zeros(n, dtype=int)
    for (i, j) in edges:
        outd[i] += 1
    return all(outd[i] >= outd[j] for (i, j) in edges)


def _assign_tpl(spg: SPG, rng: np.random.Generator, ccr: float,
                tg: Optional[Topology]) -> None:
    """Draw edge volumes so mean comm time / mean comp time == CCR."""
    if tg is not None:
        mean_comp = float(np.mean([
            [spg.comp(i, p, tg.rates) for p in range(tg.n_procs)]
            for i in range(spg.n)]))
        mean_speed = float(np.mean([tg.proc_speed(p)
                                    for p in range(tg.n_procs)]))
    else:
        mean_comp = float(spg.weights.mean())
        mean_speed = 1.0
    target_tpl = ccr * mean_comp * mean_speed
    for e in spg.edges:
        spg.tpl[e] = float(rng.uniform(0.5, 1.5) * target_tpl)

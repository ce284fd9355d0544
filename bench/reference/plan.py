"""Plain reference of the serving plan: the DSMS serving graph of a model
configuration, the one-node GPU slice topology, and HVLB_CC_IC over it.

Written from the paper's equations (Eqs. 1-16, Defs. 4.1-4.2, Eqs. 20-21)
as plain Python and NumPy: ranks per source processor, the depth-damped
priority (HPRV_CC (B), out-degree as an indicator), list scheduling with
messages routed over contended links, the alpha sweep that keeps the
first strictly shorter makespan, and the schedule holes.  The serving
graph's costs follow a roofline of the configuration's decode step
(FLOPs a stage, boundary bytes an edge).  It imports nothing of the
program; it computes every plan from the configuration and the drift
events alone, in float64, in the order the equations give.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data-sheet constants the serving graph's costs use
PEAK_FLOPS = 989e12
NVLINK_BW = 25e9
NVLINK_LINKS = 18
NET_BW = 50e9
ASSUMED_MFU = 0.5

# HVLB_CC_IC as the serving engine configures it
ALPHA_MAX = 2.0
ALPHA_STEP = 0.1
DEPTH_POWER = 2
N_STAGE_UNITS = 8
N_SLICES, GPUS_PER_SLICE, NODES = 4, 2, 1


@dataclasses.dataclass
class Graph:
    n: int
    edges: List[Tuple[int, int]]
    weights: np.ndarray
    tpl: Dict[Tuple[int, int], float]
    query_ops: Dict[int, Tuple[int, int, int]]

    def __post_init__(self) -> None:
        self.succ: List[List[int]] = [[] for _ in range(self.n)]
        self.pred: List[List[int]] = [[] for _ in range(self.n)]
        for i, j in self.edges:
            self.succ[i].append(j)
            self.pred[j].append(i)
        depth = [1] * self.n
        for u in self.topo():
            for v in self.succ[u]:
                depth[v] = max(depth[v], depth[u] + 1)
        self.depth = np.asarray(depth, dtype=float)

    def topo(self) -> List[int]:
        indeg = [len(p) for p in self.pred]
        ready = [i for i in range(self.n) if not indeg[i]]
        out: List[int] = []
        while ready:
            u = ready.pop()
            out.append(u)
            for v in self.succ[u]:
                indeg[v] -= 1
                if not indeg[v]:
                    ready.append(v)
        return out

    def drifted(self, events: Sequence[Dict[int, float]]) -> "Graph":
        """Each task's volume times each event's factor, one after another
        (Eq. 19's lambda on the mandatory part)."""
        w = self.weights.copy()
        for ev in events:
            for t, f in ev.items():
                w[t] *= f
        return Graph(self.n, list(self.edges), w, dict(self.tpl),
                     dict(self.query_ops))


@dataclasses.dataclass
class Topology:
    rates: np.ndarray
    link_speed: Dict[str, float]
    routes: Dict[Tuple[int, int], List[Tuple[str, ...]]]

    @property
    def P(self) -> int:
        return len(self.rates)

    def proc_speed(self, src: int) -> float:
        """Eq. 5: the mean over destinations of the mean over routes of
        each route's slowest link."""
        per_dst = [float(np.mean([min(self.link_speed[l] for l in r)
                                  for r in self.routes[(src, d)]]))
                   for d in range(self.P) if d != src]
        return float(np.mean(per_dst))


# ------------------------------------------------------------ the graph
def decode_block_flops(m: dict, tokens: int, kv_len: int) -> float:
    """FLOPs of one layer of a decode step (the serving graph's stage
    cost): attention and the MLP or MoE, or the Mamba-1 mixer."""
    D = m["d_model"]
    swiglu = m.get("mlp", "swiglu") in ("swiglu", "geglu")
    if m["family"] == "ssm":
        Di = m.get("expand", 2) * D
        N = m["d_state"]
        R = max(1, int(np.ceil(D / 16)))
        proj = 2 * tokens * D * 2 * Di + 2 * tokens * Di * D
        lowrank = 2 * tokens * Di * (R + 2 * N) + 2 * tokens * R * Di
        return proj + lowrank + tokens * Di * N * 6
    H, K = m["n_heads"], m["n_kv_heads"]
    dh = m.get("d_head") or D // H
    attn = (2 * tokens * D * (H * dh) * 2 + 2 * tokens * D * (K * dh) * 2
            + 2 * tokens * kv_len * H * dh * 2)
    mult = 3 if swiglu else 2
    if m["family"] == "moe":
        ffn = (2 * tokens * m["top_k"] * D * m["d_ff"] * mult
               + 2 * tokens * D * m["n_experts"])
    else:
        ffn = 2 * tokens * D * m["d_ff"] * mult
    return attn + ffn


def serving_graph(m: dict, streams: int, lifetime: int,
                  n_queries: int) -> Graph:
    """Embed, the layers in ``N_STAGE_UNITS`` stages, the head, then per
    query a map (its cost 5/10/15 % of the head's by query index), a join
    (2 %; every odd query also reads stage ``1 + q mod (n - 2)``) and a
    sink (1 %).  Volumes: the boundary activation in bf16, a tenth of it
    to each map, a twentieth to each join, a hundredth to each sink."""
    tokens, L = streams, m["n_layers"]
    block = decode_block_flops(m, tokens, lifetime)
    per_unit = max(1, L // N_STAGE_UNITS)
    units, i = [], 0
    while i < L:
        span = min(per_unit, L - i)
        units.append(block * span)
        i += span
    weights = [float(2 * tokens * m["d_model"])] + units \
        + [float(2 * tokens * m["d_model"] * m["vocab"])]
    act = float(tokens * m["d_model"] * 2)
    base_n = len(weights)
    edges = [(k, k + 1) for k in range(base_n - 1)]
    tpl = {e: act for e in edges}
    hub = base_n - 1
    query_ops = {}
    for q in range(n_queries):
        op1 = len(weights)
        weights.append(float(weights[hub]) * 0.05 * (1 + q % 3))
        edges.append((hub, op1))
        tpl[(hub, op1)] = act * 0.1
        op2 = len(weights)
        weights.append(float(weights[hub]) * 0.02)
        edges.append((op1, op2))
        tpl[(op1, op2)] = act * 0.05
        if q % 2 == 1:
            tap = 1 + (q % (base_n - 2))
            edges.append((tap, op2))
            tpl[(tap, op2)] = act * 0.05
        sink = len(weights)
        weights.append(float(weights[hub]) * 0.01)
        edges.append((op2, sink))
        tpl[(op2, sink)] = act * 0.01
        query_ops[q] = (op1, op2, sink)
    return Graph(len(weights), edges, np.asarray(weights, dtype=float), tpl,
                 query_ops)


def slice_topology() -> Topology:
    """One node of 8 GPUs cut into 4 slices of 2 in a chain of NVLink
    links ``l0``-``l2`` (each carrying the slice's GPUs' 18 links), plus
    the node's unused network bus ``dcn``; rates are the slices' FLOP/s
    at the assumed MFU."""
    rates = np.array([GPUS_PER_SLICE * PEAK_FLOPS * ASSUMED_MFU
                      for _ in range(N_SLICES)])
    per_node = N_SLICES // NODES
    links = {f"l{i}": float(GPUS_PER_SLICE * NVLINK_LINKS * NVLINK_BW)
             for i in range(N_SLICES - 1)}
    links["dcn"] = float(GPUS_PER_SLICE * NET_BW)
    routes: Dict[Tuple[int, int], List[Tuple[str, ...]]] = {}
    for a in range(N_SLICES):
        for b in range(a + 1, N_SLICES):
            assert a // per_node == b // per_node
            routes[(a, b)] = [tuple(f"l{i}" for i in range(a, b))]
            routes[(b, a)] = [tuple(f"l{i}" for i in reversed(range(a, b)))]
    return Topology(rates, links, routes)


# ----------------------------------------------------------- priorities
def comp_matrix(g: Graph, tg: Topology) -> np.ndarray:
    """Eq. 1: ``w_i / mu_p``."""
    return g.weights[:, None] / tg.rates[None, :]


def ranks(g: Graph, tg: Topology, comp: np.ndarray) -> np.ndarray:
    """Eq. 2 per source processor, the transfer at Eq. 5's speed."""
    speeds = [tg.proc_speed(p) for p in range(tg.P)]
    rank = np.zeros((g.n, tg.P))
    for u in reversed(g.topo()):
        for p in range(tg.P):
            best = 0.0
            for v in g.succ[u]:
                best = max(best, rank[v, p] + g.tpl[(u, v)] / speeds[p])
            rank[u, p] = comp[u, p] + best
    return rank


def queue_of(g: Graph, rank: np.ndarray) -> List[int]:
    """HPRV_CC (B) with the out-degree as an indicator: ``hrank /
    depth^2`` (exits 0), non-increasing; ties by hrank, then index, each
    value rounded to 6 decimals."""
    h = rank.mean(axis=1)
    has_succ = np.array([1.0 if g.succ[i] else 0.0 for i in range(g.n)])
    prv = h * has_succ / (g.depth ** DEPTH_POWER)
    return sorted(range(g.n),
                  key=lambda i: (-round(prv[i], 6), -round(h[i], 6), i))


def ldet_of(g: Graph, rank: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Eq. 16: ``rank - comp``; 1 for exit tasks."""
    out = rank - comp
    for i in range(g.n):
        if not g.succ[i]:
            out[i] = 1.0
    return out


def default_period(comp: np.ndarray) -> float:
    """Def. 4.1's period: the sum of each task's least computation time."""
    return float(sum(min(row) for row in comp.tolist()))


# ------------------------------------------------------------- schedule
@dataclasses.dataclass
class Placed:
    proc: np.ndarray
    start: np.ndarray
    finish: np.ndarray
    # (i, j) -> (lst, lft, [(link, start, finish), ...])
    messages: Dict[Tuple[int, int], Tuple[float, float,
                                          List[Tuple[str, float, float]]]]

    @property
    def makespan(self) -> float:
        return float(self.finish.max())


def _route(tg: Topology, tpl: float, src: int, dst: int, ready: float,
           link_free: Dict[str, float]):
    """Eqs. 13-15 on each route; the earliest arrival wins, ties to fewer
    hops, then to the earlier route."""
    best, best_key = None, (np.inf, 0, 0)
    for ridx, route in enumerate(tg.routes[(src, dst)]):
        ivs, lst, lft = [], None, 0.0
        for l in route:
            avail = link_free.get(l, 0.0)
            lst = max(ready, avail) if lst is None else max(lst, avail)
            lft = max(lft, lst + tpl / tg.link_speed[l])
            ivs.append((l, lst, lft))
        key = (lft, len(route), ridx)
        if key < best_key:
            best_key, best = key, ivs
    return best


def list_schedule(g: Graph, tg: Topology, queue: Sequence[int],
                  comp: np.ndarray, ldet: np.ndarray, alpha: float,
                  period: float) -> Placed:
    """Eqs. 10-15 and Defs. 4.1-4.2: each task in queue order to the
    processor of least ``EFT * LDET * (1 + load / period * alpha)`` (the
    EFT alone for an exit task), ties to the lesser EFT, then processor."""
    P = tg.P
    proc = np.full(g.n, -1, dtype=int)
    start, finish = np.zeros(g.n), np.zeros(g.n)
    proc_free, loads = np.zeros(P), np.zeros(P)
    link_free: Dict[str, float] = {}
    messages = {}
    for j in queue:
        assert all(proc[i] >= 0 for i in g.pred[j]), (j, g.pred[j])
        best = None
        for p in range(P):
            tentative = dict(link_free)
            arrival, msgs = 0.0, []
            for i in sorted(g.pred[j], key=lambda i: (finish[i], i)):
                if proc[i] == p:
                    arrival = max(arrival, finish[i])
                    continue
                ivs = _route(tg, g.tpl[(i, j)], int(proc[i]), p, finish[i],
                             tentative)
                for l, _, f in ivs:
                    tentative[l] = max(tentative.get(l, 0.0), f)
                msgs.append(((i, j), ivs))
                arrival = max(arrival, ivs[-1][2])
            est = max(proc_free[p], arrival)
            eft = est + comp[j, p]
            if not g.succ[j]:
                value = eft
            else:
                value = eft * ldet[j, p] * (1.0 + (loads[p] / period) * alpha)
            if best is None or (value, eft, p) < best[:3]:
                best = (value, eft, p, est, msgs)
        _, eft, p, est, msgs = best
        proc[j], start[j], finish[j] = p, est, eft
        proc_free[p] = eft
        loads[p] += comp[j, p]
        for e, ivs in msgs:
            messages[e] = (ivs[0][1], ivs[-1][2], ivs)
            for l, _, f in ivs:
                link_free[l] = max(link_free.get(l, 0.0), f)
    return Placed(proc, start, finish, messages)


def holes_of(g: Graph, s: Placed) -> Dict[int, float]:
    """Eqs. 20-21: the time a task may run on past its finish without
    delaying the next task on its processor, a successor there, or a
    message to another processor beyond its slack (bounded by the
    successor's start and the next message on each link of its route);
    ``inf`` where nothing follows."""
    links: Dict[str, List[Tuple[float, float, Tuple[int, int]]]] = {}
    for e, (_, _, ivs) in s.messages.items():
        for l, st, fi in ivs:
            links.setdefault(l, []).append((st, fi, e))
    for l in links:
        links[l].sort()
    holes: Dict[int, float] = {}
    for t in range(g.n):
        p = int(s.proc[t])
        on_p = sorted((i for i in range(g.n) if s.proc[i] == p),
                      key=lambda i: s.start[i])
        k = on_p.index(t)
        bounds = [float(s.start[on_p[k + 1]])] if k + 1 < len(on_p) else []
        for v in g.succ[t]:
            if int(s.proc[v]) == p:
                bounds.append(float(s.start[v]))
                continue
            lst, lft, ivs = s.messages[(t, v)]
            slack = float(s.start[v]) - lft
            for l, _, fi in ivs:
                nxt = [iv for iv in links[l]
                       if iv[0] >= fi - 1e-9 and iv[2] != (t, v)]
                if nxt:
                    slack = min(slack, nxt[0][0] - fi)
            bounds.append(lst + max(0.0, slack))
        if not bounds:
            holes[t] = float("inf")
            continue
        hole = min(bounds) - float(s.finish[t])
        if hole > 1e-9:
            holes[t] = hole
    return holes


@dataclasses.dataclass
class Plan:
    graph: Graph
    schedule: Placed
    holes: Dict[int, float]
    comp: np.ndarray
    queue: List[int]
    ldet: np.ndarray


def plan(g: Graph, tg: Topology, period: Optional[float] = None) -> Plan:
    """HVLB_CC_IC: the schedule of least makespan over alpha = 0, 0.1,
    ..., 2.0 (the first one reached that is shorter by more than 1e-12),
    with its holes.  ``period`` defaults to the graph's own."""
    comp = comp_matrix(g, tg)
    rank = ranks(g, tg, comp)
    queue = queue_of(g, rank)
    ldet = ldet_of(g, rank, comp)
    if period is None:
        period = default_period(comp)
    n_steps = int(round(ALPHA_MAX / ALPHA_STEP))
    best = None
    for k in range(n_steps + 1):
        s = list_schedule(g, tg, queue, comp, ldet, k * ALPHA_STEP, period)
        if best is None or s.makespan < best.makespan - 1e-12:
            best = s
    return Plan(g, best, holes_of(g, best), comp, queue, ldet)


class Session:
    """The plans of one stream set: the first from the fresh graph, then
    one after each drift event, each from scratch on the drifted graph
    under the first plan's period."""

    def __init__(self, g: Graph, tg: Topology) -> None:
        self.tg = tg
        self.period = default_period(comp_matrix(g, tg))
        self.current = plan(g, tg, self.period)

    def drift(self, event: Dict[int, float]) -> Plan:
        self.current = plan(self.current.graph.drifted([event]), self.tg,
                            self.period)
        return self.current

    def runs_optional(self, q: int, optional_ratio: float) -> bool:
        """Whether query ``q``'s refinement runs: its first operator's
        hole holds ``optional_ratio`` of its mandatory time there."""
        p = self.current
        node = p.graph.query_ops[q][0]
        mand = p.comp[node, int(p.schedule.proc[node])]
        return p.holes.get(node, 0.0) >= optional_ratio * mand

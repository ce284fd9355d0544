"""SPG construction from model configs and serving-query sets.

``model_stage_graph`` — the training/serving pipeline of one model as a
chain SPG (embed -> stage units -> head).

``serving_query_graph`` — the automotive-DSMS analogue: several registered
queries (applications) consume shared backbone outputs; sharing creates
high-out-degree hub nodes at depth > 1, exactly the SPG family (Section
3.2) that breaks HSV_CC ordering and motivates HVLB_CC (B).

Twin of :mod:`repro.planner.taskgraph`: the same float arithmetic, so
weights, edges, ``tpl`` and ``query_ops`` equal the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig
from ..core.graph import SPG

from .cost_model import layer_costs, stage_graph_costs


def model_stage_graph(cfg: ModelConfig, shape: ShapeConfig,
                      n_stage_units: int = 16) -> SPG:
    """Chain SPG: embed -> unit_1 .. unit_k -> head.

    Node weights are FLOPs (so ``comp = w / mu`` with mu in FLOP/s yields
    seconds); edge volumes are boundary activation bytes.
    """
    units, act_bytes = stage_graph_costs(cfg, shape, n_stage_units)
    c = layer_costs(cfg, shape)
    weights = [c["embed"]] + units + [c["head"]]
    n = len(weights)
    edges = [(i, i + 1) for i in range(n - 1)]
    g = SPG(n=n, edges=edges, weights=np.asarray(weights),
            name=f"{cfg.name}-{shape.name}")
    for e in edges:
        g.tpl[e] = float(act_bytes)
    return g


def pipeline_graph(cfg: ModelConfig, shape: ShapeConfig,
                   n_microbatches: int = 8,
                   n_stage_units: int = 16) -> SPG:
    """M parallel microbatch chains (each 1/M of the tokens).

    List-scheduling this DAG is pipeline-schedule synthesis: processor
    contention serializes stages on a slice while independent microbatches
    overlap — the GPipe bubble appears as schedule holes (which
    HVLB_CC_IC can fill with optional work, Section 4.4).
    """
    units, act_bytes = stage_graph_costs(cfg, shape, n_stage_units)
    c = layer_costs(cfg, shape)
    chain = [c["embed"]] + units + [c["head"]]
    chain = [w / n_microbatches for w in chain]
    act = act_bytes / n_microbatches
    k = len(chain)
    weights: List[float] = []
    edges: List[Tuple[int, int]] = []
    for m in range(n_microbatches):
        base = m * k
        weights.extend(chain)
        edges.extend((base + i, base + i + 1) for i in range(k - 1))
    g = SPG(n=len(weights), edges=edges, weights=np.asarray(weights),
            name=f"{cfg.name}-pipe{n_microbatches}x{k}")
    for e in edges:
        g.tpl[e] = float(act)
    return g


def serving_query_graph(cfg: ModelConfig, shape: ShapeConfig,
                        n_queries: int = 3,
                        n_stage_units: int = 8) -> SPG:
    """Backbone + per-query operator subgraphs (the DSMS workload).

    Each registered query taps the backbone output (and optionally an
    intermediate stage), runs 2-3 post-processing operators (filter /
    map / join analogues as FLOP-weighted tasks) and ends in an
    application sink.  The backbone output node acquires out-degree
    ``n_queries`` > its predecessors' out-degree — the stream-processing
    shape of the paper.

    The returned SPG carries ``query_ops``: query index -> the node ids
    of its ``(op1, op2, sink)`` operators.  Consumers (``serve.DSMSEngine``)
    must use this mapping instead of recomputing node positions from the
    graph size, so graph-shape changes cannot silently misattribute
    schedule holes.
    """
    base = model_stage_graph(cfg, shape, n_stage_units)
    weights: List[float] = list(base.weights)
    edges: List[Tuple[int, int]] = list(base.edges)
    tpl: Dict[Tuple[int, int], float] = dict(base.tpl)
    act = tpl[base.edges[0]]
    hub = base.n - 1                      # head output feeds every query
    query_ops: Dict[int, Tuple[int, int, int]] = {}
    rng = np.random.default_rng(0)
    for q in range(n_queries):
        # operator 1 (filter/map) <- hub
        op1 = len(weights)
        weights.append(float(weights[hub]) * 0.05 * (1 + q % 3))
        edges.append((hub, op1))
        tpl[(hub, op1)] = act * 0.1
        # operator 2 (join with an intermediate tap every other query)
        op2 = len(weights)
        weights.append(float(weights[hub]) * 0.02)
        edges.append((op1, op2))
        tpl[(op1, op2)] = act * 0.05
        if q % 2 == 1:
            tap = 1 + (q % (base.n - 2))
            edges.append((tap, op2))
            tpl[(tap, op2)] = act * 0.05
        # sink application
        sink = len(weights)
        weights.append(float(weights[hub]) * 0.01)
        edges.append((op2, sink))
        tpl[(op2, sink)] = act * 0.01
        query_ops[q] = (op1, op2, sink)
    g = SPG(n=len(weights), edges=edges, weights=np.asarray(weights),
            name=f"{cfg.name}-dsms-{n_queries}q")
    g.tpl.update(tpl)
    g.query_ops = query_ops
    return g

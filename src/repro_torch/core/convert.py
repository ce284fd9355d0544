"""Carry a deployment (a graph and a topology) across packages as plain
values.

A scheduling instance is to this system what weights are to a model:
the same :class:`~.graph.SPG` and :class:`~.topology.Topology` fields,
given to this package and to the JAX reference, must produce the same
schedules.  :func:`spg_arrays` / :func:`topology_arrays` read those
fields from either package's objects (the field names are shared) into
plain numpy/Python values, and :func:`spg_from_arrays` /
:func:`topology_from_arrays` build this package's objects from them.
Nothing is rounded or re-derived on the way, so a round trip loses
nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .graph import SPG
from .topology import Topology

Edge = Tuple[int, int]


def spg_arrays(g: Any) -> Dict[str, Any]:
    """The defining fields of an SPG (of either package) as plain
    values, keyed like :func:`spg_from_arrays`'s parameters."""
    return dict(
        n=int(g.n),
        edges=[(int(i), int(j)) for (i, j) in g.edges],
        weights=np.array(g.weights, dtype=float),
        tpl={(int(i), int(j)): float(v) for (i, j), v in g.tpl.items()},
        tpl_proportional_ccr=(None if g.tpl_proportional_ccr is None
                              else float(g.tpl_proportional_ccr)),
        comp_matrix=(None if g.comp_matrix is None
                     else np.array(g.comp_matrix, dtype=float)),
        name=str(g.name))


def spg_from_arrays(n: int, edges: Sequence[Edge], weights,
                    tpl: Mapping[Edge, float],
                    tpl_proportional_ccr: Optional[float],
                    comp_matrix, name: str) -> SPG:
    """This package's :class:`SPG` from plain values."""
    return SPG(n=int(n), edges=[(int(i), int(j)) for (i, j) in edges],
               weights=np.array(weights, dtype=float),
               tpl={(int(i), int(j)): float(v)
                    for (i, j), v in tpl.items()},
               tpl_proportional_ccr=tpl_proportional_ccr,
               comp_matrix=(None if comp_matrix is None
                            else np.array(comp_matrix, dtype=float)),
               name=name)


def topology_arrays(tg: Any) -> Dict[str, Any]:
    """The defining fields of a topology (of either package) as plain
    values, keyed like :func:`topology_from_arrays`'s parameters."""
    return dict(
        proc_names=[str(p) for p in tg.proc_names],
        rates=np.array(tg.rates, dtype=float),
        link_speed={str(l): float(s) for l, s in tg.link_speed.items()},
        routes={(int(a), int(b)): [tuple(str(l) for l in r) for r in rr]
                for (a, b), rr in tg.routes.items()},
        ctml_mode=str(tg.ctml_mode))


def topology_from_arrays(proc_names: Sequence[str], rates,
                         link_speed: Mapping[str, float],
                         routes: Mapping[Edge, Sequence[Sequence[str]]],
                         ctml_mode: str) -> Topology:
    """This package's :class:`Topology` from plain values."""
    rr: Dict[Edge, List[Tuple[str, ...]]] = {
        (int(a), int(b)): [tuple(r) for r in lst]
        for (a, b), lst in routes.items()}
    return Topology(list(proc_names), np.array(rates, dtype=float),
                    {str(l): float(s) for l, s in link_speed.items()}, rr,
                    ctml_mode=ctml_mode)

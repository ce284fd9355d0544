"""HVLB_CC-driven placement of stage graphs onto slices of a GPU cluster.

The cluster is carved into pipeline slices ("processors" in the paper's
model), each ``gpus_per_slice`` H100s.  Slice execution rates come from
GPUs x peak x MFU — heterogeneity enters through degraded slices
(stragglers, mixed generations).  Links: a slice boundary inside a node
rides NVLink through the node's NVSwitch; the node boundary rides the
network, one shared bus between nodes (the "gateway" of the paper's
Fig. 2 — a slower shared bus with real contention).

``plan_placement`` runs HSV_CC (baseline) or HVLB_CC (A/B) on the graph
and returns assignments + predicted step makespans.  Re-planning with
measured rates is the framework's straggler-mitigation path: static
re-scheduling, exactly the paper's answer for time-predictable systems.
``backend=`` (``"cuda"``, ``"scalar"``, ``"vector"`` or ``"auto"``),
``device=`` and ``dtype=`` (the cuda backend's real type) thread
through to the scheduler session.

Twin of :mod:`repro.planner.placement`: :func:`gpu_slice_topology` names
its processors, links and routes as the reference's
``tpu_slice_topology`` does for the same ``n_slices`` and
``pods = nodes``; only the rates and link speeds are the GPU cluster's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (HSV_CC, HVLB_CC_A, HVLB_CC_B, Scheduler, Topology,
                    load_balance)
from ..core.graph import SPG
from ..core.scheduler import Schedule

from .cost_model import HW


def gpu_slice_topology(n_slices: int = 8, gpus_per_slice: int = 8,
                       nodes: int = 2, hw: HW = HW(),
                       degraded: Optional[Dict[int, float]] = None
                       ) -> Topology:
    """Slices in a chain of links ``l{i}``; one shared bus ``dcn`` (the
    data-centre network) joins the nodes.

    A link inside a node carries ``gpus_per_slice`` GPUs' NVLink
    bandwidth (``nvlink_links × nvlink_bw`` each; the NVSwitch is
    non-blocking, so the whole of it); a link that crosses nodes, and the
    bus, carry ``gpus_per_slice`` NICs.  Link speeds are bytes/s; task
    weights are FLOPs and rates FLOP/s, so all schedule times come out in
    seconds.
    """
    degraded = degraded or {}
    rates = np.array([gpus_per_slice * hw.peak_flops * hw.mfu *
                      degraded.get(i, 1.0) for i in range(n_slices)])
    per_node = n_slices // nodes
    links: Dict[str, float] = {}
    routes: Dict[Tuple[int, int], List[Tuple[str, ...]]] = {}
    nvlink_boundary = gpus_per_slice * hw.nvlink_links * hw.nvlink_bw
    network = gpus_per_slice * hw.net_bw
    for i in range(n_slices - 1):
        same_node = (i // per_node) == ((i + 1) // per_node)
        links[f"l{i}"] = nvlink_boundary if same_node else network
    # single shared bus for any cross-node hop (contention point)
    links["dcn"] = network
    for a in range(n_slices):
        for b in range(a + 1, n_slices):
            if (a // per_node) == (b // per_node):
                routes[(a, b)] = [tuple(f"l{i}" for i in range(a, b))]
            else:
                pre = tuple(f"l{i}" for i in range(
                    a, per_node * (a // per_node + 1) - 1))
                post = tuple(f"l{i}" for i in range(
                    per_node * (b // per_node), b))
                routes[(a, b)] = [pre + ("dcn",) + post]
    return Topology([f"slice{i}" for i in range(n_slices)], rates, links,
                    routes)


@dataclasses.dataclass
class PlacementPlan:
    schedule: Schedule
    algorithm: str
    makespan_s: float
    load_balance: float
    assignment: Dict[int, int]          # stage -> slice

    @property
    def stage_map(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for t, s in self.assignment.items():
            out.setdefault(s, []).append(t)
        return out


def _policy_for(algorithm: str, alpha_max: float):
    if algorithm == "hsv":
        return HSV_CC()
    if algorithm == "hvlb_a":
        return HVLB_CC_A(alpha_max=alpha_max, alpha_step=0.05)
    if algorithm == "hvlb_b":
        return HVLB_CC_B(alpha_max=alpha_max, alpha_step=0.05)
    raise ValueError(algorithm)


def plan_placement(g: SPG, tg: Topology, algorithm: str = "hvlb_b",
                   alpha_max: float = 3.0,
                   engine: str = "compiled",
                   backend: Optional[str] = None,
                   device: Optional[str] = None,
                   dtype: Optional[torch.dtype] = None) -> PlacementPlan:
    sched = Scheduler(tg, policy=_policy_for(algorithm, alpha_max),
                      engine=engine, backend=backend, device=device,
                      dtype=dtype)
    s = sched.submit(g).schedule
    return PlacementPlan(
        schedule=s, algorithm=algorithm, makespan_s=s.makespan,
        load_balance=load_balance(s),
        assignment={i: int(s.proc[i]) for i in range(g.n)})


def replan(g: SPG, tg: Topology, measured_rates: Sequence[float],
           algorithm: str = "hvlb_b",
           engine: str = "compiled",
           backend: Optional[str] = None,
           device: Optional[str] = None,
           dtype: Optional[torch.dtype] = None) -> PlacementPlan:
    """Straggler mitigation: re-run the static scheduler with observed
    slice rates (the paper's time-predictable alternative to dynamic
    work stealing)."""
    tg2 = Topology(tg.proc_names, np.asarray(measured_rates, float),
                   dict(tg.link_speed), dict(tg.routes),
                   ctml_mode=tg.ctml_mode)
    return plan_placement(g, tg2, algorithm, engine=engine, backend=backend,
                          device=device, dtype=dtype)

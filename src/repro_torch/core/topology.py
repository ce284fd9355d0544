"""Heterogeneous network topology ``TG = <P, S, L>`` (Section 2.3).

Processors are connected by switches/gateways through links of differing
speeds; between two processors there may be several routes, each a sequence
of links.  Route speed is the average over routes of the minimum link speed
(Eqs. 3-4); a processor's data-transfer speed is the average route speed to
every other processor (Eq. 5).

Twin of ``repro.core.topology``, copied so that this package never
imports the JAX package: the same numpy arithmetic in the same order,
so every float it produces equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

Route = Tuple[str, ...]


@dataclasses.dataclass
class Topology:
    """Heterogeneous processors + multi-route contended network."""

    proc_names: List[str]
    rates: np.ndarray                       # execution rate mu per processor
    link_speed: Dict[str, float]            # link name -> speed
    routes: Dict[Tuple[int, int], List[Route]]  # (src,dst) -> route list
    # Link-level message times (CTML, Eq. 15) quantization.  The paper's
    # Gantt charts schedule messages in integer time slots ("round"); rank
    # computation always stays analytic/exact (Table 2 is fractional).
    ctml_mode: str = "exact"                # "exact" | "round" | "ceil"

    def __post_init__(self) -> None:
        self.rates = np.asarray(self.rates, dtype=float)
        self.n_procs = len(self.proc_names)
        # make routes symmetric if only one direction was given
        for (a, b), rr in list(self.routes.items()):
            if (b, a) not in self.routes:
                self.routes[(b, a)] = [tuple(reversed(r)) for r in rr]
        # Derived quantities are pure functions of the (frozen-by-convention)
        # link/route tables, so compute them once instead of re-running
        # np.mean over every route on every call.
        self._all_links: List[str] = sorted(self.link_speed)
        self._link_index: Dict[str, int] = {
            l: k for k, l in enumerate(self._all_links)}
        self._route_speed: Dict[Tuple[int, int], float] = {
            pair: float(np.mean([self.route_min_speed(r) for r in rr]))
            for pair, rr in self.routes.items()}
        self._proc_speed: Dict[int, float] = {}
        for src in range(self.n_procs):
            others = [d for d in range(self.n_procs) if d != src]
            if all((src, d) in self._route_speed for d in others):
                self._proc_speed[src] = float(np.mean(
                    [self._route_speed[(src, d)] for d in others]))

    # ------------------------------------------------------------------
    def ctml(self, tpl: float, link: str) -> float:
        """Communication time of a message on one link (Eq. 15).

        A non-positive speed (a down link in a fault-masked view, see
        :func:`~.faults.apply_to_topology`) yields ``inf`` rather than a
        ZeroDivisionError — the link is simply unusable.
        """
        sp = self.link_speed[link]
        if sp <= 0.0:
            return float("inf")
        t = tpl / sp
        if self.ctml_mode == "round":
            return float(round(t))
        if self.ctml_mode == "ceil":
            return float(np.ceil(t))
        return t

    def route_min_speed(self, route: Route) -> float:
        """Speed of a single route = slowest link on it (Eq. 4 inner min)."""
        return min(self.link_speed[l] for l in route)

    def route_speed(self, src: int, dst: int) -> float:
        """Average of per-route min speeds between src and dst (Eqs. 3-4)."""
        cached = self._route_speed.get((src, dst))
        if cached is not None:
            return cached
        rr = self.routes[(src, dst)]
        return float(np.mean([self.route_min_speed(r) for r in rr]))

    def proc_speed(self, src: int) -> float:
        """Data-transfer speed of a source processor (Eq. 5)."""
        cached = self._proc_speed.get(src)
        if cached is not None:
            return cached
        others = [d for d in range(self.n_procs) if d != src]
        return float(np.mean([self.route_speed(src, d) for d in others]))

    def all_links(self) -> List[str]:
        return list(self._all_links)

    def link_index(self) -> Dict[str, int]:
        """Stable link-name -> integer-id interning (sorted-name order)."""
        return dict(self._link_index)


def paper_topology(rates: Sequence[float] = (0.67, 1.0, 0.83),
                   ctml_mode: str = "round") -> Topology:
    """Fig. 2 of the paper.

    Star around switch s1: p1 -l1- s1, p2 -l2- s1, p3 -l4- s1, plus a direct
    p2 -l3- p3 link.  Link speeds (l1=l2=l4=1, l3=3) are the unique consistent
    assignment reproducing Table 3 route speeds and the Eq. 5 processor
    speeds (1.0, 1.5, 1.5) quoted in the text.
    """
    return Topology(
        proc_names=["p1", "p2", "p3"],
        rates=np.asarray(rates, dtype=float),
        link_speed={"l1": 1.0, "l2": 1.0, "l3": 3.0, "l4": 1.0},
        routes={
            (0, 1): [("l1", "l2"), ("l1", "l4", "l3")],
            (0, 2): [("l1", "l4"), ("l1", "l2", "l3")],
            (1, 2): [("l2", "l4"), ("l3",)],
        },
        ctml_mode=ctml_mode,
    )


def fully_switched_topology(n_procs: int, rates: Sequence[float],
                            link_speeds: Sequence[float]) -> Topology:
    """A single-switch star: every processor hangs off one switch.

    Used by the random experiments when a simple heterogeneous network is
    wanted; each pair has exactly one 2-link route through the switch.
    """
    links = {f"l{k+1}": float(s) for k, s in enumerate(link_speeds)}
    routes = {}
    for a in range(n_procs):
        for b in range(a + 1, n_procs):
            routes[(a, b)] = [(f"l{a+1}", f"l{b+1}")]
    return Topology([f"p{i+1}" for i in range(n_procs)],
                    np.asarray(rates, float), links, routes)

"""Scheduler session API: policies, submission, and the alpha sweep.

Twin of the submit path of ``repro.core.api``: a :class:`Scheduler`
session bound to one :class:`~.topology.Topology`, whose
``submit(spg, policy) -> Plan`` compiles and caches a
:class:`~.engine.CompiledInstance` per graph, builds the policy's
priority queue, and runs the policy — the Algorithm-1 alpha sweep for
the HVLB policies.

Every schedule runs on a candidate-evaluation backend
(:mod:`repro_torch.core.backends`).  The default is the device backend
``"cuda"`` on ``device="cuda"``: a fresh HVLB grid is one
``sched_plan_kernel`` launch on the card, every alpha at once.  A
session asks for the CPU with ``device="cpu"`` (the kernels' plain
PyTorch versions) or ``backend="scalar"`` (the host bit-exactness
reference, which sweeps alpha by alpha and skips the grid points inside
each simulated trace's invariance interval).  A session that did not
ask for the CPU on a host without CUDA raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .backends import CudaBackend, resolve_backend_name
from .backends.cuda import check_device
from .engine import (DEFAULT_BATCH_MAX, CompiledInstance, DecisionTrace,
                     validate_batch)
from .graph import SPG
from .imprecise import precision as _precision
from .imprecise import schedule_holes
from .ranks import hprv_a, hprv_b, ldet_cc, priority_queue, rank_matrix
from .scheduler import Schedule
from .topology import Topology
from .validate import check_graph, check_topology

# Grid alphas closer than this to a predicted trace-flip point are
# re-simulated rather than skipped (guards the last-ulp difference between
# the linear prediction A + B*alpha and the simulated Def. 4.1 value).
_SKIP_MARGIN = 1e-6


# ----------------------------------------------------------------------
# Policies
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HSV_CC:
    """Baseline policy (Xie et al. [25]): HPRV_A queue, EFT * LDET_CC
    selection — equivalent to HVLB_CC at alpha = 0, no sweep."""


@dataclasses.dataclass(frozen=True)
class HVLB_CC_A:
    """Algorithm 1 with the HSV prioritizer (Eq. 8): sweep alpha over
    ``[0, alpha_max]`` in ``alpha_step`` increments, keep min makespan.

    ``period`` is the application period of Definition 4.1.  ``None``
    pins the DAG's sum-of-min-computation proxy at first submission
    (``Plan.period`` exposes it).  ``sweep="adaptive"`` is the opt-in
    coarse-to-fine grid.
    """

    alpha_max: float = 3.0
    alpha_step: float = 0.01
    period: Optional[float] = None
    sweep: str = "grid"
    coarse_factor: int = 10
    # adaptive-sweep refinement band: coarse grid points whose makespan is
    # within this *factor* of the coarse optimum get their neighbourhood
    # re-swept at the fine step
    refine_within: float = 1.02


@dataclasses.dataclass(frozen=True)
class HVLB_CC_B(HVLB_CC_A):
    """Algorithm 1 with the depth-damped prioritizer (Eq. 9)."""

    depth_power: int = 2
    outd_mode: str = "indicator"


@dataclasses.dataclass(frozen=True)
class HVLB_CC_IC(HVLB_CC_B):
    """HVLB_CC (B) + the Section-4.4 imprecise-computation model: the
    resulting :class:`Plan` carries ``holes`` (Eqs. 20-21, exit tasks with
    nothing after them reported as ``inf``) and a ``precision(task, lam)``
    accessor (Experiment 5)."""


Policy = Union[HSV_CC, HVLB_CC_A, HVLB_CC_B, HVLB_CC_IC]


# ----------------------------------------------------------------------
# Results
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SweepResult:
    """Alpha-sweep outcome (Fig. 5 data): ``alphas[k]`` /
    ``makespans[k]`` are the grid point and its makespan."""

    best: Schedule
    best_alpha: float
    alphas: np.ndarray                   # (k,) grid alphas
    makespans: np.ndarray                # (k,) makespan per grid alpha

    @classmethod
    def from_points(cls, best: Schedule, best_alpha: float,
                    points: List[Tuple[float, float]]) -> "SweepResult":
        """Build from the sweep loops' (alpha, makespan) accumulator."""
        return cls(best, best_alpha,
                   np.array([a for a, _ in points], dtype=float),
                   np.array([m for _, m in points], dtype=float))


@dataclasses.dataclass
class ReplayStats:
    """Decision-replay accounting for one submit."""

    suffix_start: int            # first re-simulated queue position
    decisions_simulated: int     # full candidate-loop evaluations
    decisions_replayed: int      # positions re-committed from a trace
    sims_resumed: int            # alpha points resumed from a trace
    sims_full: int               # alpha points simulated from scratch
    invalidated_by_fault: int = 0
    coalesced: int = 1


@dataclasses.dataclass
class Plan:
    """Result of scheduling one graph under one policy."""

    schedule: Schedule
    policy: Policy
    graph: SPG
    period: Optional[float]      # effective (pinned) Def.-4.1 period
    sweep: Optional[SweepResult] = None
    holes: Optional[Dict[int, float]] = None     # HVLB_CC_IC only
    replay: Optional[ReplayStats] = None
    backend: Optional[str] = None    # the evaluator that ran
    batch: Optional[int] = None      # the level-batch cap

    @property
    def makespan(self) -> float:
        return self.schedule.makespan

    @property
    def proc(self) -> np.ndarray:
        return self.schedule.proc

    @property
    def best_alpha(self) -> Optional[float]:
        return self.sweep.best_alpha if self.sweep is not None else None

    def precision(self, task: int, lam: float) -> float:
        """Data precision of ``task`` at arrival rate ``lam`` (Exp. 5);
        requires an :class:`HVLB_CC_IC` plan."""
        if self.holes is None:
            raise ValueError("precision requires an HVLB_CC_IC policy "
                             "(this plan carries no schedule holes)")
        s = self.schedule
        mp = self.graph.comp(task, int(s.proc[task]), s.topology.rates)
        return _precision(mp, self.holes.get(task, 0.0), lam, ic=True)


# ----------------------------------------------------------------------
# Internals
# ----------------------------------------------------------------------
def _queue_key(policy: Policy) -> tuple:
    if isinstance(policy, HVLB_CC_B):        # covers HVLB_CC_IC
        return ("b", policy.depth_power, policy.outd_mode)
    return ("a",)                            # HSV_CC and HVLB_CC_A share Eq. 8


class _GraphSession:
    """Cached per-graph state of one Scheduler session."""

    __slots__ = ("g", "rank", "ldet", "queues", "periods", "traces",
                 "plans", "inst")

    def __init__(self, g: SPG, tg: Topology, device: torch.device) -> None:
        self.g = g
        self.rank = rank_matrix(g, tg)
        self.ldet = ldet_cc(g, tg, self.rank)
        self.inst = CompiledInstance(g, tg, rank=self.rank, ldet=self.ldet,
                                     device=device)
        self.queues: Dict[tuple, List[int]] = {}
        self.periods: Dict[Policy, float] = {}
        # traces are shared across backends and batch caps (records are
        # backend-portable, decisions batch-invariant); plans are keyed
        # by (policy, backend, batch)
        self.traces: Dict[Policy, Dict[float, DecisionTrace]] = {}
        self.plans: Dict[Tuple[Policy, str, int], Plan] = {}

    def queue_for(self, tg: Topology, policy: Policy) -> List[int]:
        key = _queue_key(policy)
        q = self.queues.get(key)
        if q is None:
            g, rank = self.g, self.rank
            if key[0] == "b":
                prv = hprv_b(g, tg, rank, depth_power=policy.depth_power,
                             outd_mode=policy.outd_mode)
            else:
                prv = hprv_a(g, tg, rank)
            q = priority_queue(prv, rank.mean(axis=1))
            self.queues[key] = q
        return q

    def default_period(self, tg: Topology) -> float:
        return self.g.default_period(tg.rates, tg.n_procs)


# ----------------------------------------------------------------------
# The session
# ----------------------------------------------------------------------
class Scheduler:
    """Long-lived scheduling session bound to one :class:`Topology`.

    ``backend`` is ``"cuda"`` (the default: hand-written kernels on
    ``device``) or ``"scalar"`` (the host reference); ``device`` is
    where the cuda backend runs — ``"cuda"`` (the default) or ``"cpu"``
    (the kernels' plain PyTorch versions).  ``batch`` caps the engine's
    level-batch (wave) width (``None`` = :data:`~.engine.
    DEFAULT_BATCH_MAX`).  Decisions are backend-, device- and
    batch-invariant, so these are performance knobs; ``submit`` accepts
    per-call ``backend``/``batch`` overrides.
    """

    def __init__(self, topology: Topology, policy: Optional[Policy] = None,
                 backend: Optional[str] = None,
                 batch: Optional[int] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        check_topology(topology)
        self.topology = topology
        self.policy: Policy = HVLB_CC_B() if policy is None else policy
        self.backend = resolve_backend_name(backend)
        self.batch = validate_batch(batch)
        self.device = torch.device("cuda" if device is None else device)
        if self.backend == CudaBackend.name:
            check_device(self.device)
        self._sessions: Dict[int, _GraphSession] = {}

    # ------------------------------------------------------------- submit
    def submit(self, g: SPG, policy: Optional[Policy] = None,
               backend: Optional[str] = None,
               batch: Optional[int] = None) -> Plan:
        """Compile (once) and schedule ``g`` under ``policy``.

        Re-submitting the same graph object reuses its compiled instance,
        priority queues, and — for an unchanged (policy, backend, batch)
        — the cached plan.
        """
        policy = self.policy if policy is None else policy
        bname = self.backend if backend is None \
            else resolve_backend_name(backend)
        if bname == CudaBackend.name:
            check_device(self.device)
        b = self.batch if batch is None else validate_batch(batch)
        bcap = DEFAULT_BATCH_MAX if b is None else b
        sess = self._sessions.get(id(g))
        if sess is None or sess.g is not g:
            check_graph(g)       # actionable errors at the boundary
            sess = _GraphSession(g, self.topology, self.device)
            self._sessions[id(g)] = sess
        plan = sess.plans.get((policy, bname, bcap))
        if plan is None:
            plan = self._plan(sess, policy, backend=bname, batch=bcap)
            sess.plans[(policy, bname, bcap)] = plan
        return plan

    # -------------------------------------------------------------- plan
    def _plan(self, sess: _GraphSession, policy: Policy, backend: str,
              batch: int) -> Plan:
        g = sess.g
        queue = sess.queue_for(self.topology, policy)
        inst = sess.inst
        sim0 = inst.n_decisions_simulated
        rep0 = inst.n_decisions_replayed

        if isinstance(policy, HSV_CC):
            # alpha = 0 makes the period irrelevant to the schedule, but it
            # is pinned anyway so recorded traces stay self-consistent
            period = sess.periods.get(policy)
            if period is None:
                period = sess.default_period(self.topology)
                sess.periods[policy] = period
            best, _, tr = inst.schedule_traced(
                queue, 0.0, period=period, want_bound=False,
                backend=backend, batch=batch)
            sess.traces[policy] = {0.0: tr}
            sims_resumed, sims_full = 0, 1
            sweep = None
        else:
            if policy.sweep not in ("grid", "adaptive"):
                raise ValueError(f"unknown sweep {policy.sweep!r}")
            period = sess.periods.get(policy)
            if period is None:
                period = policy.period if policy.period is not None \
                    else sess.default_period(self.topology)
                sess.periods[policy] = period
            traces: Dict[float, DecisionTrace] = {}
            sweep, sims_resumed, sims_full = self._sweep_compiled(
                inst, queue, policy, period, traces, backend, batch)
            sess.traces[policy] = traces
            best = sweep.best

        replay = ReplayStats(
            suffix_start=0,
            decisions_simulated=inst.n_decisions_simulated - sim0,
            decisions_replayed=inst.n_decisions_replayed - rep0,
            sims_resumed=sims_resumed, sims_full=sims_full)
        holes = schedule_holes(best, include_unbounded=True) \
            if isinstance(policy, HVLB_CC_IC) else None
        return Plan(schedule=best, policy=policy, graph=g, period=period,
                    sweep=sweep, holes=holes, replay=replay,
                    backend=backend, batch=batch)

    # ------------------------------------------------------------- sweeps
    def _sweep_compiled(self, inst: CompiledInstance, queue: Sequence[int],
                        policy: HVLB_CC_A, period: float,
                        traces: Dict[float, DecisionTrace],
                        backend: str, batch: int
                        ) -> Tuple[SweepResult, int, int]:
        n_steps = int(round(policy.alpha_max / policy.alpha_step))

        if policy.sweep == "grid" and n_steps == 0:
            # single-point grid: no rival alphas to bound against, so skip
            # the per-decision crossing tracking
            s, _, tr = inst.schedule_traced(queue, 0.0, period=period,
                                            want_bound=False,
                                            backend=backend, batch=batch)
            traces[0.0] = tr
            return SweepResult.from_points(s, 0.0, [(0.0, s.makespan)]), 0, 1

        if policy.sweep == "grid" and inst.sweep_supported(backend):
            # fused (A, B) sweep: every grid alpha's whole schedule in ONE
            # kernel launch.  Selection matches the host loop exactly:
            # the alphas the host loop skips produce bit-equal schedules
            # here, and the same strict-improvement rule scans them in the
            # same order.
            alphas = [k * policy.alpha_step for k in range(n_steps + 1)]
            swept = inst.schedule_sweep(queue, alphas, period=period,
                                        backend=backend, batch=batch)
            fbest: Optional[Schedule] = None
            fbest_alpha = 0.0
            fpoints: List[Tuple[float, float]] = []
            for alpha, (s, _bnd, tr) in zip(alphas, swept):
                traces[alpha] = tr
                fpoints.append((alpha, s.makespan))
                if fbest is None or s.makespan < fbest.makespan - 1e-12:
                    fbest, fbest_alpha = s, alpha
            assert fbest is not None
            return (SweepResult.from_points(fbest, fbest_alpha, fpoints),
                    0, len(alphas))

        n_full = 0

        def grid_pass(alphas: Sequence[float], points, best, best_alpha):
            nonlocal n_full
            k = 0
            while k < len(alphas):
                alpha = alphas[k]
                n_full += 1
                s, bnd, tr = inst.schedule_traced(
                    queue, alpha, period=period, want_bound=True,
                    backend=backend, batch=batch)
                traces[alpha] = tr
                points.append((alpha, s.makespan))
                if best is None or s.makespan < best.makespan - 1e-12:
                    best, best_alpha = s, alpha
                k += 1
                # identical decision trace => identical schedule
                while k < len(alphas) and alphas[k] < bnd - _SKIP_MARGIN:
                    points.append((alphas[k], s.makespan))
                    k += 1
            return best, best_alpha

        points: List[Tuple[float, float]] = []
        if policy.sweep == "grid":
            alphas = [k * policy.alpha_step for k in range(n_steps + 1)]
            best, best_alpha = grid_pass(alphas, points, None, 0.0)
        else:                                  # adaptive coarse-to-fine
            step, cf = policy.alpha_step, max(1, policy.coarse_factor)
            coarse = [k * step for k in range(0, n_steps + 1, cf)]
            if coarse[-1] != n_steps * step:
                coarse.append(n_steps * step)
            best, best_alpha = grid_pass(coarse, points, None, 0.0)
            assert best is not None
            # refine around every coarse point within the policy's band
            cutoff = best.makespan * policy.refine_within
            refine: set = set()
            for a, m in points:
                if m <= cutoff:
                    ka = int(round(a / step))
                    refine.update(range(max(0, ka - cf),
                                        min(n_steps, ka + cf) + 1))
            done = {round(a, 12) for a, _ in points}
            fine = [k * step for k in sorted(refine)
                    if round(k * step, 12) not in done]
            best, best_alpha = grid_pass(fine, points, best, best_alpha)
            points.sort()
        assert best is not None
        return SweepResult.from_points(best, best_alpha, points), 0, n_full


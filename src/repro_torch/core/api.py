"""Scheduler session API: policies, multi-graph submission, incremental
rescheduling and fault injection.

Twin of ``repro.core.api``.  The paper's DSMS setting is *register once,
execute continuously* (Section 4.4): schedules are recomputed whenever
queries are added, task computation times drift, or resources fail.  A
:class:`Scheduler` session bound to one :class:`~.topology.Topology` is
the long-lived surface for that loop:

  * ``submit(spg) -> Plan`` compiles and caches a
    :class:`~.engine.CompiledInstance` per graph and runs the selected
    :class:`Policy` (the Algorithm-1 alpha sweep for the HVLB policies).
  * ``submit_many([spg, ...]) -> FleetPlan`` schedules several
    independent SPGs against *shared* link state in one engine pass, as
    one disjoint-union SPG whose merged priority queue keeps each graph's
    own dequeue order.
  * ``update(task_rates=..., link_speed=...) -> Plan`` re-plans after
    drift.  For task-rate drift it re-simulates only the *suffix* of the
    memoized decision traces that the drift can reach; the prefix is
    re-committed from the trace.  ``probe_update`` measures that prefix
    without scheduling, and a matching ``update`` reuses its work.
  * ``mark_failed`` / ``degrade`` / ``restore`` record a resource fault
    and replan, invalidating exactly the trace suffix that touches the
    failed resource.

Every result is bit-identical to a from-scratch ``submit`` of the
modified graph under the same pinned period and faults, and to the
reference package's scalar backend.

Every schedule runs on a candidate-evaluation backend
(:mod:`repro_torch.core.backends`).  The default is the device backend
``"cuda"`` on ``device="cuda"``: a fresh HVLB grid is one
``sched_plan_kernel`` launch on the card, every alpha at once; a resumed
update or a fault replan launches it once per re-simulated alpha, from
the state of the replayed prefix.  A session asks for the CPU with
``device="cpu"`` (the kernels' plain PyTorch versions) or
``backend="scalar"`` (the host bit-exactness reference).  A session that
did not ask for the CPU on a host without CUDA raises.

The reference demotes a failing device backend to its NumPy backends (a
fallback chain recorded on ``Plan.fallback``).  The port has no such
chain: a kernel that fails to build or launch, and a watchdog overrun
(:class:`~.faults.WaveTimeoutError`), raise out of the session call, as
do the semantic errors (:class:`~.faults.InfeasibleScheduleError`,
:class:`~.scheduler.SchedulingFailure`).  ``Plan.fallback`` and
``FleetPlan.fallback`` are kept for API parity and are always ``None``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .backends import DEFAULT_BACKEND, CudaBackend, resolve_backend_name
from .backends.cuda import check_device, check_dtype
from .deprecation import warn_once
from .engine import (DEFAULT_BATCH_MAX, CompiledInstance, DecisionTrace,
                     validate_batch)
from .faults import (Fault, FaultSpec, InfeasibleScheduleError,
                     LinkDegraded, LinkDown, ProcessorDown)
from .graph import SPG
from .imprecise import precision as _precision
from .imprecise import schedule_holes
from .ranks import hprv_a, hprv_b, ldet_cc, priority_queue, rank_matrix
from .scheduler import Schedule, list_schedule
from .topology import Topology
from .validate import (check_graph, check_link_speeds, check_task_rates,
                       check_topology)

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
    pins the DAG's sum-of-min-computation proxy at first submission; the
    pinned value is reused by every :meth:`Scheduler.update`
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
    ``makespans[k]`` are the grid point and its makespan.  The legacy
    list-of-tuples representation survives only as the deprecated
    :attr:`curve` property."""

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

    @property
    def curve(self) -> List[Tuple[float, float]]:
        """Deprecated list-of-tuples view; use ``alphas``/``makespans``."""
        warn_once("SweepResult.curve",
                  "SweepResult.curve is deprecated; use the "
                  "SweepResult.alphas / SweepResult.makespans arrays")
        return list(zip(self.alphas.tolist(), self.makespans.tolist()))


@dataclasses.dataclass
class ReplayStats:
    """Decision-replay accounting for one submit/update."""

    suffix_start: int            # first re-simulated queue position
    decisions_simulated: int     # full candidate-loop evaluations
    decisions_replayed: int      # positions re-committed from a trace
    sims_resumed: int            # alpha points resumed from a trace
    sims_full: int               # alpha points simulated from scratch
    # queue positions a fault event invalidated (len(queue) - suffix_start
    # on fault-triggered replans; 0 on submits and benign-drift updates)
    invalidated_by_fault: int = 0
    # perturbation events folded into this replay: 1 for a submit or a
    # plain single-dict update, k when a batched ``update`` coalesced k
    # task-rate/link-speed dicts into one combined suffix replay
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
    backend: Optional[str] = None    # the evaluator ("reference": None)
    batch: Optional[int] = None      # the level-batch cap (reference: None)
    # the reference's record of backend demotions; the port demotes
    # nothing, so this is always None
    fallback: Optional[Tuple[Tuple[str, str, str], ...]] = None

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


@dataclasses.dataclass
class FleetPlan:
    """Joint schedule of several independent SPGs on one topology.

    ``schedule`` is the union schedule (tasks of graph ``k`` occupy node
    ids ``offsets[k] .. offsets[k] + graphs[k].n``); ``subschedule(k)``
    re-indexes graph ``k``'s slice back to its own node ids.
    """

    schedule: Schedule
    graphs: List[SPG]
    offsets: List[int]
    policy: Policy
    period: Optional[float]
    sweep: Optional[SweepResult] = None
    backend: Optional[str] = None
    batch: Optional[int] = None
    fallback: Optional[Tuple[Tuple[str, str, str], ...]] = None   # always None

    @property
    def makespan(self) -> float:
        return self.schedule.makespan

    def subschedule(self, k: int) -> Schedule:
        g, off = self.graphs[k], self.offsets[k]
        lo, hi = off, off + g.n
        msgs = {(i - off, j - off): dataclasses.replace(
                    m, edge=(i - off, j - off))
                for (i, j), m in self.schedule.messages.items()
                if lo <= i < hi}
        return Schedule(g, self.schedule.topology,
                        self.schedule.proc[lo:hi].copy(),
                        self.schedule.start[lo:hi].copy(),
                        self.schedule.finish[lo:hi].copy(),
                        msgs, alpha=self.schedule.alpha)


# ----------------------------------------------------------------------
# Internals
# ----------------------------------------------------------------------
def _queue_key(policy: Policy) -> tuple:
    if isinstance(policy, HVLB_CC_B):        # covers HVLB_CC_IC
        return ("b", policy.depth_power, policy.outd_mode)
    return ("a",)                            # HSV_CC and HVLB_CC_A share Eq. 8


class _GraphSession:
    """Cached per-graph state of one Scheduler session.

    The compiled instance is built lazily: :meth:`Scheduler.probe_update`
    only needs ranks/LDET/queues to measure how much of a memoized trace
    a prospective drift would invalidate.
    """

    __slots__ = ("g", "handles", "rank", "ldet", "queues", "periods",
                 "traces", "plans", "_tg", "_compiled", "_device", "_dtype",
                 "_inst", "_faults")

    def __init__(self, g: SPG, tg: Topology, compiled: bool,
                 device: torch.device,
                 faults: Optional[FaultSpec] = None,
                 dtype: torch.dtype = torch.float64,
                 rank: Optional[np.ndarray] = None,
                 ldet: Optional[np.ndarray] = None) -> None:
        self.g = g
        self.handles = [g]      # graph objects that address this session
        self._tg = tg
        self._compiled = compiled
        self._device = device
        self._dtype = dtype
        # active resource faults at session-build time; the compiled
        # instance embeds their masking, so the session cache is cleared
        # whenever the spec changes (Scheduler._fault_event).  Rank/LDET
        # stay those of the *healthy* system and may be handed over from
        # a superseded session of the same (g, tg).
        self._faults = None if faults is None or faults.is_empty else faults
        self._inst: Optional[CompiledInstance] = None
        self.rank = rank_matrix(g, tg) if rank is None else rank
        self.ldet = ldet_cc(g, tg, self.rank) if ldet is None else ldet
        self.queues: Dict[tuple, List[int]] = {}
        self.periods: Dict[Policy, float] = {}
        # traces are shared across backends and batch caps (records are
        # backend-portable, decisions batch-invariant); plans are keyed
        # by (policy, backend, batch)
        self.traces: Dict[Policy, Dict[float, DecisionTrace]] = {}
        self.plans: Dict[Tuple[Policy, Optional[str], Optional[int]],
                         Plan] = {}

    @property
    def inst(self) -> Optional[CompiledInstance]:
        if self._compiled and self._inst is None:
            self._inst = CompiledInstance(self.g, self._tg, rank=self.rank,
                                          ldet=self.ldet,
                                          faults=self._faults,
                                          device=self._device,
                                          dtype=self._dtype)
        return self._inst

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


def _rescaled_graph(g: SPG, events: Sequence[Dict[int, float]]) -> SPG:
    """The graph after arrival-rate drift: task ``t``'s computational
    volume scales by ``ev[t]`` for each event dict in order (Eq. 19's
    lambda on the mandatory part).  Factors are applied sequentially —
    ``(w * f1) * f2``, never ``w * (f1 * f2)`` — so one batched replay is
    bit-identical to replaying the events one ``update()`` at a time.
    Structure, explicit edge volumes, and names are preserved."""
    w = g.weights.copy()
    cm = None if g.comp_matrix is None else np.array(g.comp_matrix,
                                                     dtype=float)
    for ev in events:
        for t, f in ev.items():
            if not 0 <= t < g.n:
                raise ValueError(f"task {t} out of range")
            w[t] *= f
            if cm is not None:
                cm[t] *= f
    return SPG(n=g.n, edges=list(g.edges), weights=w, tpl=dict(g.tpl),
               tpl_proportional_ccr=g.tpl_proportional_ccr,
               comp_matrix=cm, name=g.name)


def _as_events(arg) -> List[dict]:
    """Normalize an ``update`` perturbation argument — one dict or a
    sequence of dicts (a batch of drift events, oldest first) — to a
    list of dicts."""
    if arg is None:
        return []
    if isinstance(arg, dict):
        return [arg]
    return [dict(ev) for ev in arg]


def _disjoint_union(graphs: Sequence[SPG], tg: Topology) -> Tuple[SPG,
                                                                  List[int]]:
    ccrs = {g.tpl_proportional_ccr for g in graphs}
    if len(ccrs) > 1:
        raise ValueError("submit_many requires every graph to share the "
                         "same tpl convention (tpl_proportional_ccr)")
    explicit = any(g.comp_matrix is not None for g in graphs)
    offsets: List[int] = []
    weights: List[float] = []
    edges: List[Tuple[int, int]] = []
    tpl: Dict[Tuple[int, int], float] = {}
    comp_rows: List[np.ndarray] = []
    off = 0
    for g in graphs:
        offsets.append(off)
        weights.extend(g.weights.tolist())
        edges.extend((i + off, j + off) for (i, j) in g.edges)
        tpl.update({(i + off, j + off): v for (i, j), v in g.tpl.items()})
        if explicit:
            comp_rows.append(g.comp_matrix_for(tg.rates))
        off += g.n
    union = SPG(n=off, edges=edges, weights=np.asarray(weights),
                tpl=tpl, tpl_proportional_ccr=next(iter(ccrs)),
                comp_matrix=np.vstack(comp_rows) if explicit else None,
                name=f"fleet[{len(graphs)}]")
    return union, offsets


# ----------------------------------------------------------------------
# The session
# ----------------------------------------------------------------------
class Scheduler:
    """Long-lived scheduling session bound to one :class:`Topology`.

    ``engine="compiled"`` (default) runs every policy on shared
    :class:`CompiledInstance` state with decision-trace memoization;
    ``engine="reference"`` re-runs the readable ``list_schedule`` per
    grid point (bit-identical results, no incremental replay — updates
    fall back to a full re-plan).

    ``backend`` is ``"cuda"`` (the default: hand-written kernels on
    ``device``), ``"scalar"`` (the host reference), ``"vector"`` (the
    (P,)-batch NumPy host backend, bit-identical to scalar; needs
    link-disjoint routes, else :class:`~.backends.BackendCompatError`)
    or ``"auto"`` (vector from 8 processors on a link-disjoint topology,
    scalar otherwise; resolved per call, never the card); ``device`` is where
    the cuda backend runs — ``"cuda"`` (the default) or ``"cpu"`` (the
    kernels' plain PyTorch versions).  ``batch`` caps the engine's
    level-batch (wave) width (``None`` = :data:`~.engine.
    DEFAULT_BATCH_MAX`).  Decisions are backend-, device- and
    batch-invariant, so these are performance knobs; ``submit``,
    ``submit_many``, ``update`` and the fault methods accept per-call
    ``backend``/``batch`` overrides.

    ``dtype`` is the cuda backend's real type for the whole session:
    ``torch.float64`` (the default, bit-identical to scalar) or
    ``torch.float32``, the reference's TPU numerics, decision-identical
    to scalar except inside the near-tie band
    (:data:`~.backends.cuda.F32_NEAR_TIE_RTOL`).  The host backends
    ignore it; traces stay portable between the two.

    ``faults`` seeds the active resource faults (a restarted service
    resumes a degraded fleet); ``wave_timeout`` (seconds, or the
    ``REPRO_SCHED_WAVE_TIMEOUT`` environment variable) is the engine
    watchdog of the device backend: a dispatch that overruns it raises
    :class:`~.faults.WaveTimeoutError` out of the call.
    """

    def __init__(self, topology: Topology, policy: Optional[Policy] = None,
                 engine: str = "compiled",
                 backend: Optional[str] = None,
                 batch: Optional[int] = None,
                 faults: Iterable[Fault] = (),
                 wave_timeout: Optional[float] = None,
                 device: Union[str, torch.device, None] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        if engine not in ("compiled", "reference"):
            raise ValueError(f"unknown engine {engine!r}")
        check_topology(topology)
        self.topology = topology
        self.policy: Policy = HVLB_CC_B() if policy is None else policy
        self.engine = engine
        # a name ("auto" too), resolved per call against the topology;
        # validated here so that a typo fails at construction
        self.backend = DEFAULT_BACKEND if backend is None else backend
        self.batch = validate_batch(batch)
        self.device = torch.device("cuda" if device is None else device)
        self.dtype = check_dtype(dtype)
        if engine == "compiled" and resolve_backend_name(
                self.backend, topology.n_procs, topology) == CudaBackend.name:
            check_device(self.device)
        # active resource faults: start from ``faults``, grown/shrunk by
        # mark_failed/degrade/restore.  ComputeSpike is graph drift, not
        # resource state — FaultSpec.from_faults rejects it here.
        self._spec = FaultSpec.from_faults(faults, topology)
        if wave_timeout is None:
            env = os.environ.get("REPRO_SCHED_WAVE_TIMEOUT", "")
            wave_timeout = float(env) if env else None
        if wave_timeout is not None and wave_timeout <= 0:
            raise ValueError(f"wave_timeout must be > 0 seconds, got "
                             f"{wave_timeout!r}")
        self.wave_timeout = wave_timeout
        self._sessions: Dict[int, _GraphSession] = {}
        self._last: Optional[_GraphSession] = None
        # probe_update's dry-run state, reused by a matching update()
        self._probe: Optional[tuple] = None

    def _resolve(self, backend: Optional[str], batch: Optional[int]
                 ) -> Tuple[Optional[str], Optional[int]]:
        """The evaluator name and level-batch cap of one call (both None
        under the reference engine).  Both are validated under either
        engine, so a typo fails loudly; a cuda backend on a host without
        CUDA raises unless the session asked for the CPU."""
        name = resolve_backend_name(
            self.backend if backend is None else backend,
            self.topology.n_procs, self.topology)
        b = self.batch if batch is None else validate_batch(batch)
        if self.engine != "compiled":
            return None, None
        if name == CudaBackend.name:
            check_device(self.device)
        return name, DEFAULT_BATCH_MAX if b is None else b

    def _new_session(self, g: SPG, **kw) -> _GraphSession:
        return _GraphSession(g, self.topology,
                             compiled=self.engine == "compiled",
                             device=self.device, faults=self._spec,
                             dtype=self.dtype, **kw)

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
        bname, bcap = self._resolve(backend, batch)
        sess = self._sessions.get(id(g))
        if sess is None or sess.g is not g:
            check_graph(g)       # actionable errors at the boundary
            sess = self._new_session(g)
            self._sessions[id(g)] = sess
        self._last = sess
        plan = sess.plans.get((policy, bname, bcap))
        if plan is None:
            plan = self._plan(sess, policy, backend=bname, batch=bcap)
            sess.plans[(policy, bname, bcap)] = plan
        return plan

    def submit_many(self, graphs: Iterable[SPG],
                    policy: Optional[Policy] = None,
                    backend: Optional[str] = None,
                    batch: Optional[int] = None) -> FleetPlan:
        """Schedule several independent SPGs against shared link state in
        one engine pass (the exp6 fleet scenario).

        The graphs are joined into one disjoint-union SPG; the merged
        priority queue is the stable merge of the per-graph queues, so
        precedence safety per graph is preserved.  The union session
        stays cached: a later ``update(task_rates=...)`` (keyed by union
        node ids) replays the fleet schedule incrementally.
        """
        graphs = list(graphs)
        if not graphs:
            raise ValueError("submit_many needs at least one graph")
        policy = self.policy if policy is None else policy
        union, offsets = _disjoint_union(graphs, self.topology)
        plan = self.submit(union, policy, backend=backend, batch=batch)
        return FleetPlan(schedule=plan.schedule, graphs=graphs,
                         offsets=offsets, policy=policy,
                         period=plan.period, sweep=plan.sweep,
                         backend=plan.backend, batch=plan.batch)

    # ------------------------------------------------------------- update
    def probe_update(self, *, task_rates: Dict[int, float],
                     graph: Optional[SPG] = None,
                     policy: Optional[Policy] = None) -> int:
        """Dry-run of ``update(task_rates=...)``: how many leading
        decisions of the memoized trace provably survive the drift.

        Costs one vectorized rank/LDET recomputation — no scheduling.
        ``n`` (every decision survives) down to ``0`` (full
        re-simulation).  A matching ``update()`` right after reuses the
        probe's prepared state.
        """
        policy = self.policy if policy is None else policy
        sess = self._session_of(graph)
        if sess is None:
            raise ValueError("probe_update() before any submit()")
        check_task_rates(task_rates, sess.g.n)
        changed = {t: f for t, f in task_rates.items() if f != 1.0}
        queue_len = len(sess.queue_for(self.topology, policy))
        if not changed:
            return queue_len
        if self.engine != "compiled":
            return 0
        new_sess = self._new_session(_rescaled_graph(sess.g, [changed]))
        prefix = self._clean_prefix(sess, new_sess, policy)
        self._probe = (sess, policy, tuple(sorted(changed.items())),
                       new_sess, prefix)
        return prefix

    def update(self, *,
               task_rates: Union[Dict[int, float],
                                 Sequence[Dict[int, float]], None] = None,
               link_speed: Union[Dict[str, float],
                                 Sequence[Dict[str, float]], None] = None,
               graph: Optional[SPG] = None,
               policy: Optional[Policy] = None,
               backend: Optional[str] = None,
               batch: Optional[int] = None) -> Plan:
        """Re-plan after drift, replaying only the affected trace suffix.

        ``task_rates`` maps task -> arrival-rate factor on its
        computational volume; ``link_speed`` overrides named link speeds
        of the session topology (which invalidates every cached instance:
        the whole trace is re-simulated).  Both accept one dict or a
        *sequence* of dicts — a batch of pending events, oldest first —
        folded into ONE combined suffix replay (task factors compose
        sequentially, later link-speed overrides win) bit-identical to k
        separate ``update()`` calls; ``ReplayStats.coalesced`` records the
        fold.  ``graph`` selects which submitted graph to update (default:
        the most recently submitted).  The returned plan is bit-identical
        to a from-scratch ``submit`` of the modified graph under the same
        pinned period (``Plan.period``).
        """
        policy = self.policy if policy is None else policy
        sess = self._session_of(graph)
        if sess is None:
            raise ValueError("update() before any submit(): the session "
                             "has no graph to re-plan")
        tr_events = _as_events(task_rates)
        ls_events = [ev for ev in _as_events(link_speed) if ev]
        for ev in tr_events:
            check_task_rates(ev, sess.g.n)
        for ev in ls_events:
            check_link_speeds(ev, self.topology)
        changed_events = [ce for ce in
                          ({t: f for t, f in ev.items() if f != 1.0}
                           for ev in tr_events) if ce]
        link_changed = bool(ls_events)
        n_events = len(changed_events) + len(ls_events)
        bname, bcap = self._resolve(backend, batch)

        if link_changed:
            speeds = dict(self.topology.link_speed)
            for ev in ls_events:
                speeds.update(ev)
            self.topology = Topology(
                list(self.topology.proc_names), self.topology.rates.copy(),
                speeds, {pair: list(rr)
                         for pair, rr in self.topology.routes.items()},
                ctml_mode=self.topology.ctml_mode)
            # every compiled instance embeds the old link speeds
            self._sessions = {}

        if not changed_events and not link_changed:
            self._sessions[id(sess.g)] = sess
            self._last = sess
            return self.submit(sess.g, policy, backend=backend, batch=batch)

        probe = self._probe
        self._probe = None
        if probe is not None and not link_changed \
                and len(changed_events) == 1 and probe[:3] == (
                    sess, policy, tuple(sorted(changed_events[0].items()))):
            new_sess, suffix_start = probe[3], probe[4]
            new_g = new_sess.g
        else:
            new_g = _rescaled_graph(sess.g, changed_events) \
                if changed_events else sess.g
            new_sess = self._new_session(new_g)
            suffix_start = 0
            if self.engine == "compiled" and not link_changed:
                suffix_start = self._clean_prefix(sess, new_sess, policy)
        new_sess.periods = dict(sess.periods)    # keep the pinned period

        prev_traces: Optional[Dict[float, DecisionTrace]] = None
        if suffix_start > 0:
            prev_traces = sess.traces.get(policy)

        try:
            plan = self._plan(new_sess, policy, prev_traces=prev_traces,
                              suffix_start=suffix_start, backend=bname,
                              batch=bcap)
        except InfeasibleScheduleError:
            # as the reference: the faults that make this replan
            # infeasible make every later one so until restore(), which
            # re-simulates from scratch
            raise
        except BaseException:
            if link_changed:
                # a device error after the topology changed and every
                # session was dropped: the last session's traces embed the
                # old link speeds, so no later update may resume from them
                self._last = None
            raise
        plan.replay.coalesced = max(1, n_events)
        new_sess.plans[(policy, bname, bcap)] = plan
        # the originally submitted handle and the new graph both address
        # this session; every map entry still pointing at the superseded
        # session is evicted (else each update would leak one session)
        new_sess.handles = [sess.handles[0], new_g]
        self._sessions = {k: v for k, v in self._sessions.items()
                          if v is not sess}
        for h in new_sess.handles:
            self._sessions[id(h)] = new_sess
        self._last = new_sess
        return plan

    # ------------------------------------------------------------- faults
    @property
    def faults(self) -> FaultSpec:
        """The active resource-fault spec (empty when healthy)."""
        return self._spec

    def mark_failed(self, *, proc: Optional[int] = None,
                    link: Optional[str] = None,
                    graph: Optional[SPG] = None,
                    policy: Optional[Policy] = None,
                    backend: Optional[str] = None,
                    batch: Optional[int] = None) -> Optional[Plan]:
        """Record a hard resource failure and replan around it.

        Exactly one of ``proc`` (processor index — :class:`ProcessorDown`)
        or ``link`` (link name — :class:`LinkDown`) must be given.  The
        replan invalidates exactly the decision-trace suffix that touches
        the failed resource: for a processor, positions from its first
        placement; for a link, positions from the first committed message
        interval on it.  ``ReplayStats.invalidated_by_fault`` counts the
        invalidated positions.

        Raises :class:`InfeasibleScheduleError` when some task has no
        feasible placement left; the fault stays recorded either way.
        Returns ``None`` when called before any ``submit`` (the fault is
        recorded and applies to every later submit).
        """
        if (proc is None) == (link is None):
            raise ValueError("mark_failed needs exactly one of "
                             "proc=<index> or link=<name>")
        fault: Fault = ProcessorDown(int(proc)) if proc is not None \
            else LinkDown(link)
        return self._apply_fault(fault, graph, policy, backend, batch)

    def degrade(self, *, link: Optional[str] = None,
                task: Optional[int] = None, factor: float,
                graph: Optional[SPG] = None,
                policy: Optional[Policy] = None,
                backend: Optional[str] = None,
                batch: Optional[int] = None) -> Optional[Plan]:
        """Record a soft degradation and replan.

        ``link=`` sets the link's slowdown factor (CTML of every message
        on it scales by ``factor``; ``factor=1`` restores nominal speed).
        ``task=`` is a :class:`~.faults.ComputeSpike`: the task's
        computational volume scales by ``factor`` via the
        ``update(task_rates=...)`` drift machinery (two spikes of 2.0
        compose to 4.0).  A degradation that makes a link *faster* than
        before conservatively invalidates the whole trace.
        """
        if (link is None) == (task is None):
            raise ValueError("degrade needs exactly one of link=<name> "
                             "or task=<index>")
        if task is not None:
            plan = self.update(task_rates={int(task): float(factor)},
                               graph=graph, policy=policy, backend=backend,
                               batch=batch)
            plan.replay.invalidated_by_fault = \
                plan.graph.n - plan.replay.suffix_start
            return plan
        return self._apply_fault(LinkDegraded(link, float(factor)),
                                 graph, policy, backend, batch)

    def restore(self, *, proc: Optional[int] = None,
                link: Optional[str] = None,
                graph: Optional[SPG] = None,
                policy: Optional[Policy] = None,
                backend: Optional[str] = None,
                batch: Optional[int] = None) -> Optional[Plan]:
        """Clear a recorded fault and replan (full re-simulation: a
        restored resource can improve *any* decision).  No-op replan if
        the resource was healthy."""
        if (proc is None) == (link is None):
            raise ValueError("restore needs exactly one of proc=<index> "
                             "or link=<name>")
        new_spec = self._spec.without(proc=proc, link=link)
        return self._fault_event(new_spec, None, graph, policy, backend,
                                 batch)

    def _apply_fault(self, fault: Fault, graph: Optional[SPG],
                     policy: Optional[Policy], backend: Optional[str],
                     batch: Optional[int]) -> Optional[Plan]:
        new_spec = self._spec.with_fault(fault, self.topology)
        scan: Optional[tuple] = None
        if isinstance(fault, ProcessorDown):
            scan = ("proc", fault.proc)
        else:                    # LinkDown / LinkDegraded
            old_f = self._spec.link_factor(fault.link)
            new_f = new_spec.link_factor(fault.link)
            if new_f >= old_f:
                # strictly-worse (or unchanged) link: the trace prefix
                # whose committed messages avoid it is provably unchanged
                scan = ("link", self.topology.link_index()[fault.link])
            # a *faster* link can improve any decision: scan stays None
        return self._fault_event(new_spec, scan, graph, policy, backend,
                                 batch)

    def _fault_event(self, new_spec: FaultSpec, scan: Optional[tuple],
                     graph: Optional[SPG], policy: Optional[Policy],
                     backend: Optional[str], batch: Optional[int]
                     ) -> Optional[Plan]:
        policy = self.policy if policy is None else policy
        bname, bcap = self._resolve(backend, batch)
        sess = self._session_of(graph)
        self._spec = new_spec
        # every cached session embeds the previous spec's masking
        self._sessions = {}
        self._probe = None
        if sess is None:
            self._last = None
            return None          # recorded; applies to every later submit
        queue = sess.queue_for(self.topology, policy)
        suffix_start = 0
        if self.engine == "compiled" and scan is not None:
            traces = sess.traces.get(policy)
            if traces:
                suffix_start = min(
                    self._fault_prefix(tr, scan) for tr in traces.values())
        prev_traces = sess.traces.get(policy) if suffix_start > 0 else None
        new_sess = self._new_session(sess.g, rank=sess.rank, ldet=sess.ldet)
        new_sess.queues = dict(sess.queues)      # healthy heuristics
        new_sess.periods = dict(sess.periods)    # keep the pinned period
        try:
            plan = self._plan(new_sess, policy, prev_traces=prev_traces,
                              suffix_start=suffix_start, backend=bname,
                              batch=bcap,
                              invalidated=len(queue) - suffix_start)
        except BaseException:
            # the fault stays recorded and the stale sessions stay
            # dropped; the last session's traces ignore the new spec, so
            # no later update may resume from them.  After an infeasible
            # spec, later submits keep raising until restore()
            self._last = None
            raise
        new_sess.plans[(policy, bname, bcap)] = plan
        new_sess.handles = list(sess.handles)
        for h in new_sess.handles:
            self._sessions[id(h)] = new_sess
        self._last = new_sess
        return plan

    @staticmethod
    def _fault_prefix(trace: DecisionTrace, scan: tuple) -> int:
        """First trace position touching the failed resource (trace
        length when none does — the whole trace survives)."""
        kind, ident = scan
        if kind == "proc":
            for k, rec in enumerate(trace.records):
                if rec[1] == ident:
                    return k
        else:
            for k, rec in enumerate(trace.records):
                for (_i, _route, iv) in rec[4]:
                    for (lid, _s, _f) in iv:
                        if lid == ident:
                            return k
        return len(trace.records)

    def _session_of(self, graph: Optional[SPG]) -> Optional[_GraphSession]:
        if graph is None:
            return self._last
        sess = self._sessions.get(id(graph))
        # identity check guards against id() reuse after a submitted graph
        # handle was garbage-collected
        if sess is not None and not any(h is graph for h in sess.handles):
            return None
        return sess

    def _clean_prefix(self, old: _GraphSession, new: _GraphSession,
                      policy: Policy) -> int:
        """First queue position whose decision the drift can reach.

        A position's decision (and its committed floats) depends only on
        the task's comp/LDET rows, its inbound message volumes, the
        shared period, and the state left by earlier positions.  Rows are
        compared exactly, so any position before the first affected one
        is provably unchanged and can be re-committed from the trace.
        """
        tg = self.topology
        old_q = old.queue_for(tg, policy)
        new_q = new.queue_for(tg, policy)
        prefix = 0
        for a, b in zip(old_q, new_q):
            if a != b:
                break
            prefix += 1
        comp_old = old.g.comp_matrix_for(tg.rates)
        comp_new = new.g.comp_matrix_for(tg.rates)
        comp_diff = np.any(comp_old != comp_new, axis=1)
        row_diff = comp_diff | np.any(old.ldet != new.ldet, axis=1)
        affected = set(np.flatnonzero(row_diff).tolist())
        if new.g.tpl_proportional_ccr is not None:
            # tpl(e_ij | p) = CCR * comp(i, p): successors' inbound
            # message volumes changed with the source's comp row
            for i in np.flatnonzero(comp_diff).tolist():
                affected.update(new.g.succ[i])
        if affected:
            pos = {t: k for k, t in enumerate(new_q)}
            prefix = min(prefix, min(pos[t] for t in affected))
        return prefix

    # -------------------------------------------------------------- plan
    def _plan(self, sess: _GraphSession, policy: Policy,
              prev_traces: Optional[Dict[float, DecisionTrace]] = None,
              suffix_start: int = 0,
              backend: Optional[str] = None,
              batch: Optional[int] = None,
              invalidated: int = 0) -> Plan:
        """Schedule ``sess.g`` under ``policy``.  The watchdog is armed on
        the device backend only, as the reference arms it on its device
        backend; whatever the backend raises propagates."""
        inst = sess.inst
        if inst is None or backend != CudaBackend.name:
            return self._plan_on(sess, policy, prev_traces, suffix_start,
                                 backend, batch, invalidated)
        inst.wave_timeout = self.wave_timeout
        try:
            return self._plan_on(sess, policy, prev_traces, suffix_start,
                                 backend, batch, invalidated)
        finally:
            inst.wave_timeout = None

    def _plan_on(self, sess: _GraphSession, policy: Policy,
                 prev_traces: Optional[Dict[float, DecisionTrace]],
                 suffix_start: int, backend: Optional[str],
                 batch: Optional[int], invalidated: int) -> Plan:
        g = sess.g
        queue = sess.queue_for(self.topology, policy)
        inst = sess.inst
        sim0 = inst.n_decisions_simulated if inst is not None else 0
        rep0 = inst.n_decisions_replayed if inst is not None else 0
        sims_resumed = sims_full = 0

        if isinstance(policy, HSV_CC):
            # alpha = 0 makes the period irrelevant to the schedule, but it
            # is pinned anyway so resumed traces stay self-consistent
            period = sess.periods.get(policy)
            if period is None:
                period = sess.default_period(self.topology)
                sess.periods[policy] = period
            if inst is None:
                best = list_schedule(g, self.topology, queue, sess.rank,
                                     alpha=0.0, ldet=sess.ldet)
                sims_full = 1
            else:
                prev = (prev_traces or {}).get(0.0)
                pos = suffix_start if prev is not None else 0
                best, _, tr = inst.schedule_traced(
                    queue, 0.0, period=period, want_bound=False,
                    resume=prev, resume_pos=pos, backend=backend,
                    batch=batch)
                sess.traces[policy] = {0.0: tr}
                sims_resumed, sims_full = (1, 0) if pos else (0, 1)
            sweep = None
        else:
            if policy.sweep not in ("grid", "adaptive"):
                raise ValueError(f"unknown sweep {policy.sweep!r}")
            if inst is None and policy.sweep != "grid":
                raise ValueError("sweep='adaptive' requires "
                                 "engine='compiled'")
            period = sess.periods.get(policy)
            if period is None:
                period = policy.period if policy.period is not None \
                    else sess.default_period(self.topology)
                sess.periods[policy] = period
            if inst is None:
                sweep = self._sweep_reference(sess, queue, policy, period)
                sims_full = len(sweep.alphas)
            else:
                traces: Dict[float, DecisionTrace] = {}
                sweep, sims_resumed, sims_full = self._sweep_compiled(
                    inst, queue, policy, period, traces,
                    prev_traces, suffix_start, backend, batch)
                sess.traces[policy] = traces
            best = sweep.best

        replay = ReplayStats(
            suffix_start=suffix_start,
            decisions_simulated=(inst.n_decisions_simulated - sim0)
            if inst is not None else sims_full * g.n,
            decisions_replayed=(inst.n_decisions_replayed - rep0)
            if inst is not None else 0,
            sims_resumed=sims_resumed, sims_full=sims_full,
            invalidated_by_fault=invalidated)
        holes = schedule_holes(best, include_unbounded=True) \
            if isinstance(policy, HVLB_CC_IC) else None
        return Plan(schedule=best, policy=policy, graph=g, period=period,
                    sweep=sweep, holes=holes, replay=replay,
                    backend=backend, batch=batch)

    # ------------------------------------------------------------- sweeps
    def _sweep_compiled(self, inst: CompiledInstance, queue: Sequence[int],
                        policy: HVLB_CC_A, period: float,
                        traces: Dict[float, DecisionTrace],
                        prev_traces: Optional[Dict[float, DecisionTrace]],
                        suffix_start: int,
                        backend: Optional[str] = None,
                        batch: Optional[int] = None
                        ) -> Tuple[SweepResult, int, int]:
        n_steps = int(round(policy.alpha_max / policy.alpha_step))
        counters = [0, 0]                      # [resumed, full]

        if policy.sweep == "grid" and n_steps == 0:
            # single-point grid (the online re-plan unit): no rival alphas
            # to bound against, so skip the per-decision crossing tracking
            prev = (prev_traces or {}).get(0.0)
            pos = suffix_start if prev is not None else 0
            s, _, tr = inst.schedule_traced(queue, 0.0, period=period,
                                            want_bound=False,
                                            resume=prev, resume_pos=pos,
                                            backend=backend, batch=batch)
            traces[0.0] = tr
            return (SweepResult.from_points(s, 0.0, [(0.0, s.makespan)]),
                    1 if pos else 0, 0 if pos else 1)

        if policy.sweep == "grid" and not (prev_traces and suffix_start) \
                and inst.sweep_supported(backend):
            # fused (A, B) sweep: every grid alpha's whole schedule in ONE
            # kernel launch.  Fresh grids only — a resumable update goes
            # through the host loop below, which replays per-alpha trace
            # prefixes.  Selection matches the host loop exactly: the
            # alphas the host loop skips produce bit-equal schedules here,
            # and the same strict-improvement rule scans them in order.
            # The traces kept are those of the alphas the host loop
            # simulates (the same bounds skip the same alphas), so later
            # updates and fault replans resume exactly as the reference's
            alphas = [k * policy.alpha_step for k in range(n_steps + 1)]
            swept = inst.schedule_sweep(queue, alphas, period=period,
                                        backend=backend, batch=batch)
            fbest: Optional[Schedule] = None
            fbest_alpha = 0.0
            fpoints: List[Tuple[float, float]] = []
            skip_below = -float("inf")
            for alpha, (s, bnd, tr) in zip(alphas, swept):
                if not alpha < skip_below:
                    traces[alpha] = tr
                    # analysis: allow[float-arith] trace-invariance skip bound; margin only widens the re-evaluated alpha set, never changes a schedule
                    skip_below = bnd - _SKIP_MARGIN
                fpoints.append((alpha, s.makespan))
                # analysis: allow[float-arith] strict-improvement epsilon on a reduction over backend outputs, not a per-decision value
                if fbest is None or s.makespan < fbest.makespan - 1e-12:
                    fbest, fbest_alpha = s, alpha
            assert fbest is not None
            return (SweepResult.from_points(fbest, fbest_alpha, fpoints),
                    0, len(alphas))

        def grid_pass(alphas: Sequence[float], points, best, best_alpha):
            k = 0
            while k < len(alphas):
                alpha = alphas[k]
                prev = (prev_traces or {}).get(alpha)
                pos = suffix_start if prev is not None else 0
                counters[0 if pos else 1] += 1
                s, bnd, tr = inst.schedule_traced(
                    queue, alpha, period=period, want_bound=True,
                    resume=prev, resume_pos=pos, backend=backend,
                    batch=batch)
                traces[alpha] = tr
                points.append((alpha, s.makespan))
                # analysis: allow[float-arith] strict-improvement epsilon on a reduction over backend outputs, not a per-decision value
                if best is None or s.makespan < best.makespan - 1e-12:
                    best, best_alpha = s, alpha
                k += 1
                # identical decision trace => identical schedule
                # analysis: allow[float-arith] trace-invariance skip bound; margin only widens the re-evaluated alpha set, never changes a schedule
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
        return (SweepResult.from_points(best, best_alpha, points),
                counters[0], counters[1])

    def _sweep_reference(self, sess: _GraphSession, queue: Sequence[int],
                         policy: HVLB_CC_A, period: float) -> SweepResult:
        g, tg = sess.g, self.topology
        n_steps = int(round(policy.alpha_max / policy.alpha_step))
        best: Optional[Schedule] = None
        best_alpha = 0.0
        points: List[Tuple[float, float]] = []
        for k in range(n_steps + 1):
            alpha = k * policy.alpha_step
            s = list_schedule(g, tg, queue, sess.rank, alpha=alpha,
                              period=period, ldet=sess.ldet)
            points.append((alpha, s.makespan))
            # analysis: allow[float-arith] same strict-improvement epsilon as the session sweep (deprecated shim must stay bit-identical)
            if best is None or s.makespan < best.makespan - 1e-12:
                best, best_alpha = s, alpha
        assert best is not None
        return SweepResult.from_points(best, best_alpha, points)

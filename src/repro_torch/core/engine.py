"""Compiled scheduling engine: the decision layer of the Eq. 10-15 loop.

Twin of ``repro.core.engine``.  ``list_schedule`` in :mod:`.scheduler` is
the readable reference; :class:`CompiledInstance` preprocesses an
``(SPG, Topology)`` pair once —

  * link names interned to integer ids (``Topology.link_index`` order),
  * route tables flattened to ``(link_id, link_speed)`` tuples per
    ``(src, dst)`` pair,
  * per-(edge, source-processor) communication volumes ``tpl(e_ij | p)``,
  * the cached ``(n, P)`` computation matrix, the rank/LDET matrices and
    the default period

— and runs the selection loop on top of a pluggable **candidate
evaluation backend** (:mod:`repro_torch.core.backends`): ``"scalar"``
(flat Python lists, the bit-exactness reference) or ``"cuda"`` (the
device backend: hand-written CUDA kernels on the card, their plain
PyTorch versions on the CPU).  The engine itself is the *decision
layer*: queue walk, precedence checks, decision-trace recording/replay,
and :class:`~.scheduler.Schedule` assembly.

The queue walk is **level-batched**: :func:`plan_waves` cuts the queue
into *waves*, maximal runs of consecutive queue entries carrying no
precedence edge into the wave, and the whole plan goes to the backend
in one ``evaluate_plan`` call.  Decisions are batch-invariant (waves
still evaluate and commit sequentially inside the backend; batching
only moves the loop), which is what lets the device backend run a whole
schedule — and a whole alpha grid — in one kernel launch.

Along a fixed decision trace every candidate's selection value is
linear in alpha (``value_p(a) = A_p + B_p * a``), so after simulating
one alpha the engine reports the supremum alpha up to which every
decision's winner provably keeps winning
(:meth:`CompiledInstance.schedule_with_bound`); the session's host-side
alpha sweep skips the grid points inside that interval.
:meth:`CompiledInstance.schedule_traced` records every committed
decision, and a later call may *resume* from such a trace: the prefix
is re-committed from the record (the same floating-point commits in the
same order) and only the suffix is re-evaluated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union, TYPE_CHECKING

import numpy as np

from .backends import CandidateEvaluator, backend_class, resolve_backend_name
from .backends.cuda import check_dtype
from .faults import (DOWN_COMP, INFEASIBLE_EFT, FaultSpec,
                     InfeasibleScheduleError)
from .graph import SPG
from .ranks import ldet_cc, rank_matrix
from .scheduler import MessagePlacement, Schedule, SchedulingFailure
from .topology import Topology

if TYPE_CHECKING:                                   # pragma: no cover
    import torch

_INF = float("inf")

# a registered backend name, or an evaluator bound to the instance
BackendArg = Union[str, CandidateEvaluator, None]

# Default cap on the level-batch size the decision layer hands to
# ``CandidateEvaluator.evaluate_batch`` (``batch=None``).  Decisions are
# batch-invariant — the cap only bounds kernel unroll/staging cost for
# device backends; ``batch=1`` recovers the strict per-decision walk.
DEFAULT_BATCH_MAX = 16


def validate_batch(batch) -> Optional[int]:
    """Validated level-batch cap (``None`` passes through as "default").

    Loud on anything but a genuine int >= 1: a non-integral value must
    not silently truncate to a cap (and a session plan-cache key) the
    caller never asked for.  Single source of truth for the engine and
    the session API.
    """
    if batch is None:
        return None
    if isinstance(batch, bool) or int(batch) != batch or int(batch) < 1:
        raise ValueError(f"batch must be an int >= 1, got {batch!r}")
    return int(batch)


def plan_waves(queue: Sequence[int], preds_of: Sequence[Sequence[int]],
               batch_cap: int) -> List[List[int]]:
    """The level-batched **wave plan** of a queue: maximal runs of
    consecutive queue entries with no precedence edge *into the run*,
    capped at ``batch_cap``.

    A pure function of the static structure ``(queue, precedence edges,
    cap)`` — no schedule state — which is what lets the engine emit the
    whole plan up front and hand it to the backend in one
    ``evaluate_plan`` call (the device backend folds the entire plan
    into a single dispatch).  Tasks sharing a rank level are the
    canonical wave; the direct predecessor check also absorbs
    independent tasks of interleaved levels (transitive dependencies
    cannot hide inside a wave: a precedence-safe queue would place the
    intermediate task inside it too).  Decisions are wave-cap-invariant,
    so the plan shape never changes the schedule.
    """
    waves: List[List[int]] = []
    nq = len(queue)
    qi = 0
    while qi < nq:
        wave = set()
        hi = qi
        while hi < nq and hi - qi < batch_cap:
            j = queue[hi]
            if any(i in wave for i in preds_of[j]):
                break                    # depends on the wave: next one
            wave.add(j)
            hi += 1
        waves.append(list(queue[qi:hi]))
        qi = hi
    return waves


# One committed decision:
# (task, proc, est, eft, msgs, cand_A, cand_B, batch_id).
# ``msgs`` is the winner's [(pred, route, [(link_id, lst, lft), ...]), ...];
# cand_A/cand_B are P-tuples of the linear selection coefficients (None for
# exit tasks or when the run did not track the alpha bound).  ``batch_id``
# is the index of the level batch that produced the decision — purely
# informational (decisions are batch-invariant), but recorded so a resumed
# run can keep its batch numbering monotone and the equivalence tests can
# assert identical grouping across backends and packages.
DecisionRecord = Tuple[int, int, float, float, list, Optional[tuple],
                       Optional[tuple], int]


@dataclasses.dataclass
class DecisionTrace:
    """Memoized decision sequence of one :meth:`CompiledInstance._run`.

    Replayable: committing ``records[:k]`` reconstructs the exact engine
    state after the first ``k`` dequeues, so an update whose first ``k``
    decisions are provably unchanged re-simulates only positions ``k..n``.
    """

    queue: Tuple[int, ...]
    alpha: float
    period: float
    want_bound: bool
    records: List[DecisionRecord]


class CompiledInstance:
    """One-time preprocessing of an ``(SPG, Topology)`` pair.

    Build once, then call :meth:`schedule` (or
    :meth:`schedule_with_bound`) any number of times — the alpha sweep,
    online re-planning, and the throughput benchmarks all share the same
    instance.
    """

    def __init__(self, g: SPG, tg: Topology,
                 rank: Optional[np.ndarray] = None,
                 ldet: Optional[np.ndarray] = None,
                 faults: Optional[FaultSpec] = None,
                 device: "Union[str, torch.device, None]" = None,
                 dtype: "Optional[torch.dtype]" = None) -> None:
        self.g, self.tg = g, tg
        # where the device backend keeps its tables and runs its kernels:
        # the card unless the caller asks for the CPU (plain versions)
        self.device = "cuda" if device is None else device
        # the device backend's real type (float64, or float32 for the
        # near-tie mode); the host backends ignore it
        self.dtype = check_dtype(dtype)
        self.P = P = tg.n_procs
        self.n = g.n
        # Fault masking: a down processor's comp column and
        # a faulted link's effective speed are masked with *finite*
        # sentinels right here, so every backend runs its unmodified
        # healthy-path arithmetic and a masked candidate simply carries an
        # EFT beyond the feasibility horizon.  Rank/LDET/queues stay those
        # of the healthy system (priorities are estimates, and freezing
        # them is what keeps the fault-untouched trace prefix replayable).
        if faults is not None and faults.is_empty:
            faults = None
        self.faults = faults
        self.wave_timeout: Optional[float] = None   # engine watchdog (s)

        comp = g.comp_matrix_for(tg.rates)
        if faults is not None and faults.down_procs:
            comp = comp.copy()          # never poison the graph's cache
            comp[:, list(faults.down_procs)] = DOWN_COMP
        self.comp = comp
        self._comp = comp.tolist()
        self.rank = rank_matrix(g, tg) if rank is None else rank
        self.ldet = ldet_cc(g, tg, self.rank) if ldet is None else ldet
        self._ldet = self.ldet.tolist()
        self.default_period = g.default_period(tg.rates, P)

        self._link_names = tg.all_links()
        self._n_links = len(self._link_names)
        link_id = tg.link_index()
        if faults is not None and faults.link_factors:
            def _speed(l: str) -> float:
                return faults.effective_speed(l, float(tg.link_speed[l]))
        else:
            def _speed(l: str) -> float:
                return float(tg.link_speed[l])
        # (src, dst) -> [(link_ids, link_speeds, route_tuple), ...] in the
        # reference's route order (ties prefer fewer hops then route index).
        # Speeds are the fault-effective ones; backends/layout.py reads
        # them from here, so one masking point covers every backend.
        self._routes: Dict[Tuple[int, int], List[
            Tuple[Tuple[int, ...], Tuple[float, ...], Tuple[str, ...]]]] = {}
        for pair, rr in tg.routes.items():
            self._routes[pair] = [
                (tuple(link_id[l] for l in r),
                 tuple(_speed(l) for l in r),
                 r) for r in rr]
        # tpl(e_ij | p_src) per edge; constant over p unless the graph uses
        # the worked-example CCR-proportional convention.
        self._tpl: Dict[Tuple[int, int], List[float]] = {
            (i, j): [g.comm_volume(i, j, self._comp[i][p]) for p in range(P)]
            for (i, j) in g.edges}
        self._preds: List[List[int]] = [list(g.pred[j]) for j in range(g.n)]
        self._is_exit: List[bool] = [not g.succ[j] for j in range(g.n)]
        self._ctml_mode = tg.ctml_mode
        # (i, j, src, dst) -> [(link_ids, ctml_per_hop, route), ...]:
        # CTML (Eq. 15, incl. quantization) is static per edge/route, so it
        # is computed once on first use and reused by every later candidate
        # evaluation, alpha step, and re-plan.
        self._msg_plans: Dict[Tuple[int, int, int, int], List[
            Tuple[Tuple[int, ...], Tuple[float, ...],
                  Tuple[str, ...]]]] = {}
        # Decision-replay accounting (read by api.Scheduler / the tests):
        # positions evaluated with the full candidate loop vs positions
        # re-committed from a memoized trace.
        self.n_decisions_simulated = 0
        self.n_decisions_replayed = 0
        # candidate-evaluation backends, built lazily per name
        self._backends: Dict[str, CandidateEvaluator] = {}
        # per-source-processor route-tensor layouts (backends/layout.py),
        # shared by every array backend and every edge of this instance,
        # plus the (E, P) tpl matrix / edge interning the all-edge CTML
        # precompilation indexes by
        self._src_layouts: Dict[int, object] = {}
        self._edge_index: Dict[Tuple[int, int], int] = {
            e: k for k, e in enumerate(g.edges)}
        self._tpl_matrix = np.array(
            [self._tpl[e] for e in g.edges]).reshape(len(g.edges), P)

    # ------------------------------------------------------------------
    def msg_plans_for(self, i: int, j: int, src: int, dst: int) -> list:
        """Cached per-route ``(link_ids, CTMLs, route_names)`` for message
        ``e_ij`` travelling ``src -> dst`` — the scalar backend's Eq. 15
        CTML source.  The device backend quantizes the same values
        vectorized in ``backends/layout.py`` (``ensure_ct_table``);
        the two code paths must stay elementwise bit-identical."""
        key = (i, j, src, dst)
        plans = self._msg_plans.get(key)
        if plans is None:
            tpl = self._tpl[(i, j)][src]
            quant_round = self._ctml_mode == "round"
            quant_ceil = self._ctml_mode == "ceil"
            plans = []
            for (lids, spds, robj) in self._routes[(src, dst)]:
                cts = []
                for sp in spds:
                    t = tpl / sp                             # Eq. 15
                    if quant_round:
                        t = float(round(t))
                    elif quant_ceil:
                        t = float(np.ceil(t))
                    cts.append(t)
                plans.append((lids, tuple(cts), robj))
            self._msg_plans[key] = plans
        return plans

    # ------------------------------------------------------------------
    def backend_instance(self, backend: BackendArg = None
                         ) -> CandidateEvaluator:
        """The (cached) evaluator for a backend name (``None`` = the
        device backend), or ``backend`` itself when it is an evaluator
        already bound to this instance (e.g. a per-wave
        ``CudaBackend(inst, scan=False)``)."""
        if isinstance(backend, CandidateEvaluator):
            if backend.inst is not self:
                raise ValueError("backend evaluator is bound to another "
                                 "CompiledInstance")
            return backend
        name = resolve_backend_name(backend, self.P, self.tg)
        be = self._backends.get(name)
        if be is None:
            be = backend_class(name)(self)
            self._backends[name] = be
        return be

    # ------------------------------------------------------------------
    def schedule(self, queue: Sequence[int], alpha: float = 0.0,
                 period: Optional[float] = None,
                 backend: BackendArg = None,
                 batch: Optional[int] = None) -> Schedule:
        """Array-core equivalent of :func:`~.scheduler.list_schedule`.

        ``batch`` caps the level-batch size handed to the backend's
        ``evaluate_batch`` (``None`` = :data:`DEFAULT_BATCH_MAX`, ``1`` =
        strict per-decision walk).  Decisions are batch-invariant; the
        knob trades kernel-launch amortization against staging size on
        device backends and is a no-op for scalar.
        """
        s, _, _ = self._run(queue, alpha, period, want_bound=False,
                            backend=backend, batch=batch)
        return s

    def schedule_with_bound(self, queue: Sequence[int], alpha: float,
                            period: Optional[float] = None,
                            backend: BackendArg = None,
                            batch: Optional[int] = None
                            ) -> Tuple[Schedule, float]:
        """Schedule at ``alpha`` and return ``(schedule, bound)`` where the
        decision trace — hence the schedule — is provably unchanged for
        every ``alpha' in [alpha, bound)``."""
        s, bound, _ = self._run(queue, alpha, period, want_bound=True,
                                backend=backend, batch=batch)
        return s, bound

    def schedule_traced(self, queue: Sequence[int], alpha: float = 0.0,
                        period: Optional[float] = None,
                        want_bound: bool = True,
                        resume: Optional[DecisionTrace] = None,
                        resume_pos: int = 0,
                        backend: BackendArg = None,
                        batch: Optional[int] = None
                        ) -> Tuple[Schedule, float, DecisionTrace]:
        """Schedule and memoize the decision trace.

        With ``resume``/``resume_pos`` the first ``resume_pos`` decisions
        are re-committed from the given trace instead of re-evaluated —
        the suffix-replay primitive behind :meth:`api.Scheduler.update`.
        The caller must guarantee the prefix decisions are unchanged
        (same comp/LDET rows, message volumes, and queue prefix); the
        result is then bit-identical to a from-scratch run.  Traces are
        backend-portable: records hold plain floats and committing them
        is backend-shared scalar code, so a trace recorded under one
        backend resumes bit-identically under another.
        """
        return self._run(queue, alpha, period, want_bound=want_bound,
                         record=True, resume=resume, resume_pos=resume_pos,
                         backend=backend, batch=batch)

    # -------------------------------------------------------- fused sweep
    def sweep_supported(self, backend: BackendArg = None) -> bool:
        """Whether :meth:`schedule_sweep` can run on this backend — i.e.
        the resolved evaluator fuses whole alpha grids into one dispatch
        (``CandidateEvaluator.supports_plan_sweep``)."""
        return self.backend_instance(backend).supports_plan_sweep()

    def schedule_sweep(self, queue: Sequence[int], alphas: Sequence[float],
                       period: Optional[float] = None,
                       backend: BackendArg = None,
                       batch: Optional[int] = None
                       ) -> List[Tuple[Schedule, float, DecisionTrace]]:
        """Schedule one queue under **every** alpha of a grid in a single
        device dispatch (the (A, B) fused sweep).

        Per-alpha results are identical to ``len(alphas)`` independent
        :meth:`schedule_traced` calls with ``want_bound=True`` — same
        decisions, same recorded traces (so a later ``update()`` resumes
        from them exactly like host-loop sweep traces), same
        :class:`~.faults.InfeasibleScheduleError` on the first infeasible
        (alpha, task) in sweep order.  Only valid when
        :meth:`sweep_supported`; fresh runs only (resume goes through the
        per-alpha host loop, which replays prefixes per trace).
        """
        g, tg = self.g, self.tg
        preds_of = self._preds
        names = self._link_names
        if period is None:
            period = self.default_period
        batch_cap = validate_batch(batch)
        if batch_cap is None:
            batch_cap = DEFAULT_BATCH_MAX
        be = self.backend_instance(backend)
        be.start(alphas[0] if alphas else 0.0, period, True)
        waves = plan_waves(list(queue), preds_of, batch_cap)
        scheduled = [False] * self.n
        for wave_js in waves:
            for j in wave_js:
                for i in preds_of[j]:
                    if not scheduled[i]:
                        raise SchedulingFailure(
                            f"task {j} dequeued before predecessor {i} "
                            f"(Sec. 3.2)")
            for j in wave_js:
                scheduled[j] = True
        faulted = self.faults is not None
        swept = be.evaluate_plan_sweep(waves, list(alphas), period,
                                       timeout=self.wave_timeout)
        out: List[Tuple[Schedule, float, DecisionTrace]] = []
        for alpha, per_wave in zip(alphas, swept):
            messages: Dict[Tuple[int, int], MessagePlacement] = {}
            records: List[DecisionRecord] = []
            bound = _INF
            procs = np.full(self.n, -1, dtype=np.int64)
            ast_ = np.zeros(self.n)
            aft_ = np.zeros(self.n)
            bid = 0
            for wave_js, decisions in zip(waves, per_wave):
                for j, (p, est, eft, msgs, ca, cb, contrib) in zip(
                        wave_js, decisions):
                    if faulted and not eft < INFEASIBLE_EFT:
                        raise InfeasibleScheduleError(j, eft, self.faults)
                    for (i, route, iv) in msgs:
                        messages[(i, j)] = MessagePlacement(
                            (i, j), int(procs[i]), p, route,
                            [(names[lid], s_, f) for (lid, s_, f) in iv])
                    procs[j] = p
                    ast_[j] = est
                    aft_[j] = eft
                    if contrib < bound:
                        bound = contrib
                    records.append((j, p, est, eft, msgs, ca, cb, bid))
                bid += 1
            self.n_decisions_simulated += len(records)
            tr = DecisionTrace(tuple(queue), alpha, period, True, records)
            out.append((Schedule(g, tg, procs, ast_, aft_, messages,
                                 alpha=alpha), bound, tr))
        return out

    # ------------------------------------------------------------------
    def _run(self, queue: Sequence[int], alpha: float,
             period: Optional[float], want_bound: bool,
             record: bool = False,
             resume: Optional[DecisionTrace] = None,
             resume_pos: int = 0,
             backend: BackendArg = None,
             batch: Optional[int] = None
             ) -> Tuple[Schedule, float, Optional[DecisionTrace]]:
        g, tg = self.g, self.tg
        preds_of = self._preds
        names = self._link_names
        if period is None:
            period = self.default_period
        batch_cap = validate_batch(batch)
        if batch_cap is None:
            batch_cap = DEFAULT_BATCH_MAX

        be = self.backend_instance(backend)
        be.start(alpha, period, want_bound)
        proc_of = be.proc_of
        scheduled = [False] * self.n
        messages: Dict[Tuple[int, int], MessagePlacement] = {}
        bound = _INF
        records: List[DecisionRecord] = []

        start = 0
        bid = 0                      # next live batch id (monotone in-trace)
        if resume is not None and resume_pos > 0:
            if resume.alpha != alpha or resume.want_bound != want_bound \
                    or resume.period != period:
                raise ValueError("resume trace was recorded under different "
                                 "(alpha, period, bound-tracking) settings")
            if tuple(queue[:resume_pos]) != resume.queue[:resume_pos]:
                raise ValueError("resume trace queue prefix mismatch")
            start = resume_pos
            # Re-commit the memoized prefix: the same floating-point state
            # updates in the same order as the original run — no candidate
            # evaluation, no route walks.  Record commits are shared scalar
            # code, so the trace may come from any backend (and any batch
            # grouping: decisions are batch-invariant, the recorded batch
            # id is carried along untouched).
            for rec in resume.records[:resume_pos]:
                j, p, est, eft, msgs, ca, cb, rec_bid = rec
                be.apply(j, p, est, eft, msgs)
                for (i, route, iv) in msgs:
                    messages[(i, j)] = MessagePlacement(
                        (i, j), proc_of[i], p, route,
                        [(names[lid], s_, f) for (lid, s_, f) in iv])
                scheduled[j] = True
                if want_bound and ca is not None:
                    # same crossing-point arithmetic as the live path, on
                    # the memoized candidate coefficients
                    b = be.crossing(p, ca, cb, alpha)
                    if b < bound:
                        bound = b
                if record:
                    records.append(rec)
                bid = rec_bid + 1    # a resumed suffix may split a batch
            self.n_decisions_replayed += resume_pos

        # Level-batched queue walk, planned **up front**: the wave plan
        # is a pure function of (queue, precedence edges, cap) — see
        # :func:`plan_waves` — so the engine emits the complete plan,
        # proves precedence safety over it, and hands the whole thing to
        # the backend in ONE ``evaluate_plan`` call.  The sequential
        # default walks it wave-by-wave through ``evaluate_batch`` (the
        # exact op order of an interleaved loop — scalar stays bit-exact);
        # the device backend folds the entire plan into a single kernel
        # launch.  Decisions inside a
        # wave still interact through link/processor state and are
        # evaluated sequentially; the contract is batch-invariance.
        q = list(queue[start:]) if start else list(queue)
        waves = plan_waves(q, preds_of, batch_cap)
        for wave_js in waves:
            for j in wave_js:
                for i in preds_of[j]:
                    if not scheduled[i]:
                        raise SchedulingFailure(
                            f"task {j} dequeued before predecessor {i} "
                            f"(Sec. 3.2)")
            for j in wave_js:
                scheduled[j] = True
        sim_count = 0
        faulted = self.faults is not None
        per_wave = be.evaluate_plan(waves, timeout=self.wave_timeout,
                                    bid0=bid)
        for wave_js, decisions in zip(waves, per_wave):
            for j, (p, est, eft, msgs, ca, cb, contrib) in zip(wave_js,
                                                               decisions):
                if faulted and not eft < INFEASIBLE_EFT:
                    # the *winner* is only reachable through a masked
                    # resource: no feasible placement exists for j
                    raise InfeasibleScheduleError(j, eft, self.faults)
                for (i, route, iv) in msgs:
                    messages[(i, j)] = MessagePlacement(
                        (i, j), proc_of[i], p, route,
                        [(names[lid], s_, f) for (lid, s_, f) in iv])
                if contrib < bound:
                    bound = contrib
                if record:
                    records.append((j, p, est, eft, msgs, ca, cb, bid))
            sim_count += len(wave_js)
            bid += 1

        self.n_decisions_simulated += sim_count
        trace = DecisionTrace(tuple(queue), alpha,
                              period, want_bound, records) if record else None
        return Schedule(g, tg, np.array(proc_of), np.array(be.ast),
                        np.array(be.aft), messages, alpha=alpha), bound, trace

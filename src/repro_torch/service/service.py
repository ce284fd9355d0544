"""Scheduler-as-a-service: the asyncio serving front-end.

Twin of ``repro.service.service``.  :class:`SchedulerService` wraps
long-lived :class:`repro_torch.core.Scheduler` sessions behind an async
request API for many logical clients (tenants); every tenant's session
runs its kernels on the service's ``device`` (the card by default):

  * **Request coalescing** — every request lands in its tenant's pending
    queue; a flush armed ``window`` seconds out drains the queue and
    folds adjacent same-kind runs (:mod:`.coalescing`): a
    burst of registrations becomes ONE ``submit_many`` fleet replan, a
    burst of drift updates becomes ONE batched suffix-replay
    ``Scheduler.update``.  Each request still gets its own response,
    resolved from the coalesced result.
  * **Sharding** — tenants are assigned to worker lanes by consistent
    hashing (:mod:`.sharding`); each lane serializes its
    own tenants (one ``asyncio.Lock``) and owns their Scheduler
    sessions, so independent tenants never contend on one session or
    share plan/trace caches.
  * **Graceful retiming** — drift and fault requests route through the
    exact suffix-invalidation paths of the session API;
    :class:`~repro_torch.core.InfeasibleScheduleError` surfaces as the
    structured ``infeasible`` response.  A kernel that fails to build or
    launch, a CUDA error and a watchdog overrun are not demoted to
    another backend: the request gets the structured ``device-error``
    response, the failure is logged, the tenant's fleet plan is dropped
    so that its next request rebuilds it from the last adopted state,
    and the service goes on serving.

Everything observable is deterministic: shard placement is seeded
hashing, coalescing never reorders requests, and the schedules returned
are bit-identical to a direct single-session :class:`Scheduler` replaying
the same request sequence (the chaos tests' oracle).  An *invalid*
request never poisons the burst it rode in on: items are validated
before any mutation and fail individually, and a coalesced replan that
fails outright falls back to uncoalesced per-item processing — so the
valid items of a mixed burst land exactly as they would one at a time.
The only clock reads are monotonic latency *accounting* — never a
scheduling input.

Each lane executes its batches on its own single worker thread
(``run_in_executor``), so one long replan never stalls other lanes or
the TCP accept/read loop; the per-lane ``asyncio.Lock`` plus the
one-thread executor preserve per-lane serialization, which is what the
determinism oracle needs.  Lanes share the kernel libraries, which
build once and count launches under their own locks
(:mod:`repro_torch._nvcc`).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .._nvcc import KernelError
from ..core import (HVLB_CC_B, FleetPlan, InfeasibleScheduleError, Plan,
                    Policy, ReplayStats, Scheduler, Topology)
from ..core.backends import CudaBackend, resolve_backend_name
from ..core.backends.cuda import check_device, check_dtype
from ..core.faults import (Fault, FaultSpec, LinkDegraded, LinkDown,
                           ProcessorDown, WaveTimeoutError)
from ..core.graph import SPG
from ..core.validate import check_link_speeds, check_task_rates

from .coalescing import Batch, coalesce
from .protocol import OPS, Response
from .sharding import HashRing, shard_key

__all__ = ["DEVICE_ERRORS", "SchedulerService", "ServiceClient",
           "ServiceError", "ServiceStats"]

_log = logging.getLogger(__name__)

#: failures of the card answered with ``device-error``: a kernel library
#: that failed to build or a launch that returned a CUDA error, a CUDA
#: error raised by PyTorch around the kernels, and a watchdog overrun
DEVICE_ERRORS = (KernelError, WaveTimeoutError, torch.AcceleratorError)


class ServiceError(Exception):
    """A structured per-request failure (``code`` is one of the
    protocol's :data:`~.protocol.ERROR_CODES`)."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


def _spec_as_faults(spec: FaultSpec) -> Tuple[Fault, ...]:
    """The active fault spec as constructor-ready ``Fault`` records (the
    same round-trip the chaos tests use to seed a fresh Scheduler)."""
    faults: List[Fault] = [ProcessorDown(p) for p in spec.down_procs]
    for link, f in spec.link_factors:
        faults.append(LinkDown(link) if math.isinf(f)
                      else LinkDegraded(link, f))
    return tuple(faults)


def _slice_union(union: SPG, names_sizes: Sequence[Tuple[str, int]],
                 offsets: Sequence[int]) -> List[SPG]:
    """Split a (possibly drifted) disjoint-union SPG back into per-graph
    SPGs.  Edge/tpl insertion order and every float are preserved, so
    re-unioning the slices reproduces ``union`` bit-identically — this
    is how drift applied to the fleet union survives the next
    registration burst's fresh ``submit_many``.
    """
    out: List[SPG] = []
    for (name, n), off in zip(names_sizes, offsets):
        hi = off + n
        out.append(SPG(
            n=n,
            edges=[(i - off, j - off)
                   for (i, j) in union.edges if off <= i < hi],
            weights=union.weights[off:hi].copy(),
            tpl={(i - off, j - off): v
                 for (i, j), v in union.tpl.items() if off <= i < hi},
            tpl_proportional_ccr=union.tpl_proportional_ccr,
            comp_matrix=None if union.comp_matrix is None
            else union.comp_matrix[off:hi].copy(),
            name=name))
    return out


@dataclasses.dataclass
class ServiceStats:
    """Service-level accounting (the exp10 measurements)."""

    requests: int = 0
    batches: int = 0
    replans: int = 0              # actual Scheduler invocations
    coalesced_events: int = 0     # requests folded into those replans
    plan_cache_hits: int = 0      # plan ops answered without scheduling
    errors: int = 0
    evictions: int = 0            # LRU tenant-session evictions
    replan_latencies_s: List[float] = dataclasses.field(
        default_factory=list)

    def mean_replan_latency_s(self) -> float:
        lat = self.replan_latencies_s
        return sum(lat) / len(lat) if lat else 0.0

    def p99_replan_latency_s(self) -> float:
        lat = sorted(self.replan_latencies_s)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, max(0, math.ceil(0.99 * len(lat)) - 1))]

    def view(self) -> Dict[str, Any]:
        return {
            "requests": self.requests, "batches": self.batches,
            "replans": self.replans,
            "coalesced_events": self.coalesced_events,
            "plan_cache_hits": self.plan_cache_hits,
            "errors": self.errors, "evictions": self.evictions,
            "mean_replan_latency_s": self.mean_replan_latency_s(),
            "p99_replan_latency_s": self.p99_replan_latency_s(),
        }


@dataclasses.dataclass
class _Item:
    """One pending request: kind + params + the future its response
    resolves."""

    kind: str
    params: Dict[str, Any]
    future: "asyncio.Future[Response]"
    rid: int = 0


@dataclasses.dataclass
class _Tenant:
    """Per-tenant serving state, owned by exactly one worker lane."""

    name: str
    lane: int
    topology: Topology                       # drifts with link_speed updates
    graphs: Dict[str, SPG] = dataclasses.field(default_factory=dict)
    sched: Optional[Scheduler] = None
    fleet: Optional[FleetPlan] = None
    period: Optional[float] = None           # pinned fleet period (LRU rebuild)
    fault_records: Tuple[Fault, ...] = ()
    pending: List[_Item] = dataclasses.field(default_factory=list)
    flush_armed: bool = False
    last_used: int = 0                       # service-wide LRU tick


_FAULT_OPS = ("mark_failed", "degrade", "restore")


class SchedulerService:
    """Async scheduling service over a pool of sharded worker lanes.

    ``window`` is the coalescing debounce in seconds (``0`` = flush on
    the next event-loop tick — a synchronously-enqueued burst still
    coalesces); ``coalesce=False`` keeps the async machinery but
    processes every request as its own singleton batch (the exp10
    baseline).  ``max_tenants_per_worker`` bounds live Scheduler
    sessions per lane with LRU eviction; an evicted tenant keeps its
    graphs/faults/pinned period and is transparently rebuilt on its
    next request.  ``backend``, ``device`` and ``dtype`` are every
    tenant session's (the cuda backend on the card in float64 by
    default; ``dtype=torch.float32`` is the near-tie mode); a service
    asked to run on a card the host does not have raises here.
    """

    def __init__(self, topology: Topology,
                 policy: Optional[Policy] = None, *,
                 workers: int = 4, window: float = 0.0,
                 coalesce: bool = True,
                 backend: Optional[str] = None,
                 batch: Optional[int] = None,
                 max_tenants_per_worker: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        self.device = torch.device("cuda" if device is None else device)
        self.dtype = check_dtype(dtype)
        if resolve_backend_name(backend, topology.n_procs,
                                topology) == CudaBackend.name:
            check_device(self.device)
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if window < 0:
            raise ValueError(f"window must be >= 0 seconds, got {window}")
        if max_tenants_per_worker is not None and max_tenants_per_worker < 1:
            raise ValueError("max_tenants_per_worker must be >= 1")
        self.topology = topology
        self.policy = policy
        self.backend = backend
        self.batch = batch
        self.window = window
        self.coalesce = coalesce
        self.max_tenants_per_worker = max_tenants_per_worker
        self.stats = ServiceStats()
        self._topo_tag = (f"{topology.n_procs}p-"
                          f"{len(topology.all_links())}l")
        shards = [f"w{i}" for i in range(workers)]
        self._ring = HashRing(shards)
        self._lane_of = {name: i for i, name in enumerate(shards)}
        self._locks = [asyncio.Lock() for _ in range(workers)]
        self._executors: List[Optional[ThreadPoolExecutor]] = \
            [None] * workers                 # lazily, one thread per lane
        self._tenants: Dict[str, _Tenant] = {}
        # the loop inserts tenants (_tenant) while lane threads snapshot
        # the table for LRU eviction (_evict_lru); dict mutation during
        # iteration raises, so both sides take this lock
        self._tenants_lock = threading.Lock()
        self._lru_tick = 0
        # the event loop holds only weak task refs: anchor flush tasks
        # here or a GC pass could drop one mid-debounce, stranding its
        # tenant's pending futures
        self._flush_tasks: set = set()
        # stats are mutated from worker-lane threads and read from the
        # loop ("stats" op); a plain += on an int attribute is not atomic
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------------ client
    def client(self, tenant: str) -> "ServiceClient":
        """An in-process client bound to one tenant."""
        return ServiceClient(self, tenant)

    def tenant_lane(self, tenant: str) -> int:
        """The worker lane that owns ``tenant`` (pure function of the
        shard key — see :func:`.sharding.shard_key`)."""
        return self._lane_of[self._ring.lookup(
            shard_key(tenant, self._topo_tag))]

    async def request(self, tenant: str, op: str,
                      rid: int = 0, **params: Any) -> Response:
        """Enqueue one request and await its (possibly coalesced)
        response.  Never raises for scheduling failures — those come
        back as ``ok=False`` responses with a structured error."""
        if op == "stats":
            with self._stats_lock:
                return Response.success(rid, self.stats.view())
        if op not in OPS:
            return Response.failure(rid, "bad-request",
                                    f"unknown op {op!r}")
        with self._stats_lock:
            self.stats.requests += 1
        t = self._tenant(tenant)
        fut: "asyncio.Future[Response]" = \
            asyncio.get_running_loop().create_future()
        t.pending.append(_Item(op, params, fut, rid))
        if not t.flush_armed:
            t.flush_armed = True
            task = asyncio.get_running_loop().create_task(
                self._flush_later(t))
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_tasks.discard)
        return await fut

    def close(self) -> None:
        """Shut down the worker-lane threads (idempotent; in-flight
        batches finish first — drain pending requests before calling)."""
        for i, ex in enumerate(self._executors):
            if ex is not None:
                ex.shutdown(wait=True)
                self._executors[i] = None

    # ----------------------------------------------------------- routing
    def _tenant(self, name: str) -> _Tenant:
        with self._tenants_lock:
            t = self._tenants.get(name)
            if t is None:
                t = _Tenant(name=name, lane=self.tenant_lane(name),
                            topology=self.topology)
                self._tenants[name] = t
        return t

    async def _flush_later(self, t: _Tenant) -> None:
        await asyncio.sleep(self.window)
        loop = asyncio.get_running_loop()
        async with self._locks[t.lane]:
            items, t.pending = t.pending, []
            t.flush_armed = False
            if not items:
                return
            if self.coalesce:
                batches = coalesce(items, lambda it: it.kind)
            else:
                batches = [Batch(it.kind, [it]) for it in items]
            self._touch(t)
            ex = self._executor(t.lane)
            for b in batches:
                # scheduling runs OFF the event loop; the lane lock +
                # one-thread executor keep per-lane serialization
                await loop.run_in_executor(ex, self._run_batch, t, b)

    def _executor(self, lane: int) -> ThreadPoolExecutor:
        ex = self._executors[lane]
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"repro-service-w{lane}")
            self._executors[lane] = ex
        return ex

    def _touch(self, t: _Tenant) -> None:
        self._lru_tick += 1
        t.last_used = self._lru_tick

    # --------------------------------------------------------- execution
    def _run_batch(self, t: _Tenant, batch: Batch) -> None:
        with self._stats_lock:
            self.stats.batches += 1
        try:
            if batch.kind == "register":
                self._do_register(t, batch)
            elif batch.kind == "update":
                self._do_update(t, batch)
            elif batch.kind == "plan":
                self._do_plan(t, batch)
            elif batch.kind in _FAULT_OPS:
                self._do_fault(t, batch)
            else:
                raise ServiceError("bad-request",
                                   f"unhandled op {batch.kind!r}")
        except ServiceError as e:
            self._fail(batch, e.code, str(e))
        except InfeasibleScheduleError as e:
            # no valid plan until a restore (or feasible replan): drop
            # the stale fleet so later ops rebuild instead of serving it
            t.fleet = None
            self._fail(batch, "infeasible", str(e))
        except DEVICE_ERRORS as e:
            # the card failed; nothing runs the request elsewhere.  The
            # session may be half-updated: drop the fleet so the next
            # request rebuilds it from the last adopted state
            _log.error("tenant %s: %s batch failed on the device: %s: %s",
                       t.name, batch.kind, type(e).__name__, e,
                       exc_info=True)
            t.fleet = None
            self._fail(batch, "device-error", f"{type(e).__name__}: {e}")
        except (KeyError, TypeError, ValueError) as e:
            self._fail(batch, "bad-request", str(e))
        except Exception as e:
            # last-resort: a bug must surface as a response, never as a
            # dead flush task with clients awaiting forever
            self._fail(batch, "internal", f"{type(e).__name__}: {e}")

    def _fail(self, batch: Batch, code: str, message: str) -> None:
        for it in batch.items:
            self._fail_item(it, code, message)

    def _fail_item(self, it: _Item, code: str, message: str) -> None:
        if not it.future.done():
            with self._stats_lock:
                self.stats.errors += 1
            _set_threadsafe(it.future, Response.failure(it.rid, code,
                                                        message))

    def _resolve(self, it: _Item, result: Dict[str, Any]) -> None:
        if not it.future.done():
            _set_threadsafe(it.future, Response.success(it.rid, result))

    # -- register ------------------------------------------------------
    def _do_register(self, t: _Tenant, batch: Batch) -> None:
        # validate BEFORE mutating: an invalid item fails alone and the
        # valid items still land — exactly as they would uncoalesced
        ok: List[Tuple[_Item, str, SPG]] = []
        bad: List[Tuple[_Item, str]] = []
        taken = set(t.graphs)
        for it in batch.items:
            g = it.params.get("graph")
            if not isinstance(g, SPG):
                bad.append((it, "register needs graph=<SPG>"))
                continue
            name = it.params.get("name") or g.name
            if name in taken:
                bad.append((it, f"graph {name!r} already registered "
                                f"for tenant {t.name!r}"))
                continue
            taken.add(name)
            ok.append((it, name, g))
        if ok:
            try:
                for _, name, g in ok:
                    t.graphs[name] = g
                self._replan_fleet(t, coalesced=len(ok))
            except BaseException as e:
                for _, name, _ in ok:
                    t.graphs.pop(name, None)
                if len(batch.items) > 1 and isinstance(e, Exception):
                    # the union replan failed, but a prefix may still be
                    # feasible: fall back to uncoalesced per-item
                    # processing (bit-identical to coalesce=False; the
                    # invalid items re-fail item by item)
                    for it in batch.items:
                        self._run_batch(t, Batch(batch.kind, [it]))
                    return
                raise
            for it, name, _ in ok:
                self._resolve(it, self._graph_view(t, name))
        for it, msg in bad:
            self._fail_item(it, "bad-request", msg)

    def _replan_fleet(self, t: _Tenant, coalesced: int,
                      pin_period: bool = False) -> None:
        """One fresh ``submit_many`` over the tenant's whole graph set
        (register bursts and post-eviction rebuilds).

        ``pin_period=True`` (rebuilds over an *unchanged* graph set)
        carries the tenant's pinned fleet period into the fresh session
        so an LRU eviction stays invisible to the schedules served; a
        registration burst changes the union, so it re-derives the
        period exactly like a direct fresh ``submit_many`` would.
        """
        policy = self.policy if self.policy is not None else HVLB_CC_B()
        if pin_period and t.period is not None \
                and hasattr(policy, "period") and policy.period is None:
            policy = dataclasses.replace(policy, period=t.period)
        sched = self._scheduler(t, policy)
        t0 = self._now()
        fleet = sched.submit_many(list(t.graphs.values()))
        self._record_replan(t0, coalesced)
        t.sched, t.fleet = sched, fleet
        t.period = fleet.period
        self._evict_lru(t.lane)

    def _scheduler(self, t: _Tenant,
                   policy: Optional[Policy]) -> Scheduler:
        return Scheduler(t.topology, policy=policy, backend=self.backend,
                         batch=self.batch, faults=t.fault_records,
                         device=self.device, dtype=self.dtype)

    def _require_session(self, t: _Tenant) -> Scheduler:
        if not t.graphs:
            raise ServiceError(
                "no-graphs",
                f"tenant {t.name!r} has no registered graphs")
        if t.sched is None or t.fleet is None:
            # post-eviction rebuild over the unchanged graph set
            self._replan_fleet(t, coalesced=0, pin_period=True)
        assert t.sched is not None
        return t.sched

    # -- update --------------------------------------------------------
    def _do_update(self, t: _Tenant, batch: Batch) -> None:
        sched = self._require_session(t)
        if t.fleet is None:
            raise ServiceError("internal",
                               "no fleet plan after session rebuild")
        names = list(t.graphs)
        offsets = dict(zip(names, t.fleet.offsets))
        # validate BEFORE replanning: an invalid item fails alone while
        # the valid items fold into the one suffix replay
        ok: List[_Item] = []
        bad: List[Tuple[_Item, ServiceError]] = []
        tr_events: List[Dict[int, float]] = []
        ls_events: List[Dict[str, float]] = []
        for it in batch.items:
            try:
                tr_ev, ls_ev = self._parse_update(t, it.params, names,
                                                  offsets)
            except ServiceError as e:
                bad.append((it, e))
                continue
            ok.append(it)
            if tr_ev:
                tr_events.append(tr_ev)
            if ls_ev:
                ls_events.append(ls_ev)
        if ok:
            t0 = self._now()
            try:
                plan = sched.update(task_rates=tr_events or None,
                                    link_speed=ls_events or None)
            except Exception:
                if len(batch.items) > 1:
                    # the combined replay failed; fall back to
                    # uncoalesced per-item processing so any feasible
                    # prefix still lands
                    for it in batch.items:
                        self._run_batch(t, Batch(batch.kind, [it]))
                    return
                raise
            self._record_replan(t0, coalesced=len(ok))
            self._adopt_union_plan(t, plan)
            replay = _replay_view(plan.replay)
            for it in ok:
                gname = it.params.get("graph")
                if gname is not None:
                    self._resolve(it, self._graph_view(t, gname,
                                                       replay=replay))
                else:
                    self._resolve(it, self._fleet_view(t, replay=replay))
        for it, e in bad:
            self._fail_item(it, e.code, str(e))

    def _parse_update(self, t: _Tenant, params: Dict[str, Any],
                      names: Sequence[str], offsets: Dict[str, int]
                      ) -> Tuple[Dict[int, float], Dict[str, float]]:
        """One update item's drift events in union coordinates, fully
        validated (mirrors the session API's own checks so the batched
        ``Scheduler.update`` cannot reject an item after the fact)."""
        tr_ev: Dict[int, float] = {}
        tr = params.get("task_rates")
        if tr:
            gname = params.get("graph")
            if gname is None:
                if len(names) != 1:
                    raise ServiceError(
                        "bad-request",
                        "task_rates needs graph=<name> when several "
                        "graphs are registered")
                gname = names[0]
            if gname not in offsets:
                raise ServiceError(
                    "bad-request",
                    f"unknown graph {gname!r} for tenant {t.name!r}")
            off, g = offsets[gname], t.graphs[gname]
            try:
                local = {int(task): float(f) for task, f in tr.items()}
                check_task_rates(local, g.n)
            except (TypeError, ValueError) as e:
                raise ServiceError("bad-request", str(e)) from e
            tr_ev = {off + task: f for task, f in local.items()}
        ls_ev: Dict[str, float] = {}
        ls = params.get("link_speed")
        if ls:
            try:
                ls_ev = {str(k): float(v) for k, v in ls.items()}
                check_link_speeds(ls_ev, t.topology)
            except (TypeError, ValueError) as e:
                raise ServiceError("bad-request", str(e)) from e
        return tr_ev, ls_ev

    def _adopt_union_plan(self, t: _Tenant, plan: Plan) -> None:
        """Fold a union-graph ``Plan`` back into the tenant's fleet
        state: per-graph SPGs are re-sliced from the (possibly drifted)
        union so the next registration burst re-unions bit-identically.
        """
        assert t.fleet is not None and t.sched is not None
        names_sizes = [(name, g.n) for name, g in t.graphs.items()]
        sliced = _slice_union(plan.graph, names_sizes, t.fleet.offsets)
        t.graphs = {name: g for (name, _), g in zip(names_sizes, sliced)}
        t.topology = t.sched.topology
        t.period = plan.period
        t.fleet = FleetPlan(schedule=plan.schedule, graphs=sliced,
                            offsets=list(t.fleet.offsets),
                            policy=plan.policy, period=plan.period,
                            sweep=plan.sweep, backend=plan.backend,
                            batch=plan.batch)

    # -- faults --------------------------------------------------------
    def _do_fault(self, t: _Tenant, batch: Batch) -> None:
        it = batch.items[0]        # fault ops are singleton barriers
        p = it.params
        if batch.kind == "degrade" and p.get("task") is not None:
            # a compute spike addresses a task of the live fleet union,
            # so it needs a session WITH a plan: "no-graphs" before any
            # registration, transparently rebuilt after an eviction or
            # an infeasible replan (which may re-raise as "infeasible")
            sched = self._require_session(t)
        elif t.sched is None:
            # no live session (pre-registration, or evicted): record the
            # fault on a graphless session — deliberately NOT a fleet
            # rebuild first, so a restore can lift an infeasible fault
            # without having to replan under it
            t.sched = self._scheduler(t, self.policy)
            sched = t.sched
        else:
            sched = t.sched
        t0 = self._now()
        try:
            if batch.kind == "mark_failed":
                plan = sched.mark_failed(proc=p.get("proc"),
                                         link=p.get("link"))
            elif batch.kind == "degrade":
                if p.get("task") is not None:
                    plan = sched.degrade(
                        task=self._union_task(t, p.get("graph"),
                                              int(p["task"])),
                        factor=float(p["factor"]))
                else:
                    plan = sched.degrade(link=p.get("link"),
                                         factor=float(p["factor"]))
            else:                  # restore
                plan = sched.restore(proc=p.get("proc"),
                                     link=p.get("link"))
        finally:
            # the fault stays recorded even on an infeasible replan;
            # fresh sessions (register bursts, rebuilds) must carry it
            t.fault_records = _spec_as_faults(sched.faults)
        if plan is None:
            if t.graphs:
                # the session lost its fleet (an earlier infeasible
                # replan dropped it): replan from scratch under the new
                # fault state
                self._replan_fleet(t, coalesced=len(batch),
                                   pin_period=True)
                self._resolve(it, self._fleet_view(t))
            else:                  # recorded for later registrations
                self._resolve(it, {"tenant": t.name, "deferred": True,
                                   "faults": _fault_view(sched.faults)})
            return
        self._record_replan(t0, coalesced=len(batch))
        self._adopt_union_plan(t, plan)
        self._resolve(it, self._fleet_view(
            t, replay=_replay_view(plan.replay)))

    def _union_task(self, t: _Tenant, gname: Optional[str],
                    task: int) -> int:
        if t.fleet is None:
            raise ServiceError("internal",
                               "task degrade needs a live fleet plan")
        names = list(t.graphs)
        if gname is None:
            if len(names) != 1:
                raise ServiceError(
                    "bad-request",
                    "task degrade needs graph=<name> when several "
                    "graphs are registered")
            gname = names[0]
        if gname not in t.graphs:
            raise ServiceError("bad-request",
                               f"unknown graph {gname!r} for tenant "
                               f"{t.name!r}")
        g = t.graphs[gname]
        if not 0 <= task < g.n:
            raise ServiceError(
                "bad-request",
                f"task {task} out of range for graph {gname!r} "
                f"(n={g.n})")
        return t.fleet.offsets[names.index(gname)] + task

    # -- plan ----------------------------------------------------------
    def _do_plan(self, t: _Tenant, batch: Batch) -> None:
        self._require_session(t)
        for it in batch.items:
            gname = it.params.get("graph")
            if gname is not None and gname not in t.graphs:
                # an unknown graph fails alone, not its batch-mates
                self._fail_item(it, "bad-request",
                                f"unknown graph {gname!r} for tenant "
                                f"{t.name!r}")
                continue
            with self._stats_lock:
                self.stats.plan_cache_hits += 1
            if gname is not None:
                self._resolve(it, self._graph_view(t, gname))
            else:
                self._resolve(it, self._fleet_view(t))

    # -- LRU -----------------------------------------------------------
    def _evict_lru(self, lane: int) -> None:
        cap = self.max_tenants_per_worker
        if cap is None:
            return
        # snapshot: runs on a lane thread while the loop may be
        # inserting new tenants into the dict
        with self._tenants_lock:
            snapshot = list(self._tenants.values())
        live = [t for t in snapshot
                if t.lane == lane and t.sched is not None]
        for t in sorted(live, key=lambda t: t.last_used)[:-cap]:
            # drop the session (plans, traces, compiled instances); the
            # tenant keeps graphs + faults + pinned period and is
            # rebuilt bit-identically on its next request
            t.sched, t.fleet = None, None
            with self._stats_lock:
                self.stats.evictions += 1

    # -- views ---------------------------------------------------------
    def _fleet_view(self, t: _Tenant,
                    replay: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        f = t.fleet
        assert f is not None
        return {
            "tenant": t.name,
            "graphs": list(t.graphs),
            "makespan": float(f.makespan),
            "period": None if f.period is None else float(f.period),
            "alpha": (None if f.schedule.alpha is None
                      else float(f.schedule.alpha)),
            "backend": f.backend,
            "batch": f.batch,
            "fallback": (None if not f.fallback
                         else [list(x) for x in f.fallback]),
            "faults": _fault_view(t.sched.faults) if t.sched else None,
            "replay": replay,
        }

    def _graph_view(self, t: _Tenant, name: str,
                    replay: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        assert t.fleet is not None
        sub = t.fleet.subschedule(list(t.graphs).index(name))
        view = self._fleet_view(t, replay=replay)
        view.update({
            "graph": name,
            "graph_makespan": float(sub.makespan),
            "proc": [int(x) for x in sub.proc],
            "start": [float(x) for x in sub.start],
            "finish": [float(x) for x in sub.finish],
        })
        return view

    # -- accounting ----------------------------------------------------
    def _now(self) -> float:
        # monotonic duration probe for latency accounting only, never a
        # scheduling input (runs on worker-lane threads, off the loop)
        return time.monotonic()

    def _record_replan(self, t0: float, coalesced: int) -> None:
        dt = self._now() - t0
        with self._stats_lock:
            self.stats.replans += 1
            self.stats.coalesced_events += coalesced
            self.stats.replan_latencies_s.append(dt)


def _set_result(fut: "asyncio.Future[Response]", resp: Response) -> None:
    if not fut.done():
        fut.set_result(resp)


def _set_threadsafe(fut: "asyncio.Future[Response]",
                    resp: Response) -> None:
    """Resolve ``fut`` from any thread: batches run on worker-lane
    threads, but an asyncio future may only be resolved on its loop."""
    fut.get_loop().call_soon_threadsafe(_set_result, fut, resp)


def _replay_view(replay: Optional[ReplayStats]
                 ) -> Optional[Dict[str, Any]]:
    if replay is None:
        return None
    return {"suffix_start": replay.suffix_start,
            "decisions_replayed": replay.decisions_replayed,
            "decisions_simulated": replay.decisions_simulated,
            "invalidated_by_fault": replay.invalidated_by_fault,
            "coalesced": replay.coalesced}


def _fault_view(spec: FaultSpec) -> Dict[str, Any]:
    return {"down_procs": list(spec.down_procs),
            "link_factors": {link: ("down" if math.isinf(f) else f)
                             for link, f in spec.link_factors}}


class ServiceClient:
    """In-process client bound to one tenant (tests/benchmarks; the TCP
    front-end in :mod:`.__main__` speaks the same ops over
    :mod:`.protocol`)."""

    def __init__(self, service: SchedulerService, tenant: str) -> None:
        self.service = service
        self.tenant = tenant

    async def register(self, graph: SPG,
                       name: Optional[str] = None) -> Response:
        return await self.service.request(
            self.tenant, "register", graph=graph, name=name)

    async def update(self, *,
                     task_rates: Optional[Dict[int, float]] = None,
                     link_speed: Optional[Dict[str, float]] = None,
                     graph: Optional[str] = None) -> Response:
        return await self.service.request(
            self.tenant, "update", task_rates=task_rates,
            link_speed=link_speed, graph=graph)

    async def mark_failed(self, *, proc: Optional[int] = None,
                          link: Optional[str] = None) -> Response:
        return await self.service.request(
            self.tenant, "mark_failed", proc=proc, link=link)

    async def degrade(self, *, link: Optional[str] = None,
                      graph: Optional[str] = None,
                      task: Optional[int] = None,
                      factor: float) -> Response:
        return await self.service.request(
            self.tenant, "degrade", link=link, graph=graph, task=task,
            factor=factor)

    async def restore(self, *, proc: Optional[int] = None,
                      link: Optional[str] = None) -> Response:
        return await self.service.request(
            self.tenant, "restore", proc=proc, link=link)

    async def plan(self, graph: Optional[str] = None) -> Response:
        return await self.service.request(self.tenant, "plan",
                                          graph=graph)

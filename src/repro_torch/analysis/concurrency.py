"""Concurrency race detector for the hybrid asyncio/thread service layer.

Twin of ``repro.analysis.concurrency``, run over the port's
``repro_torch.service``, which keeps the reference's design: it mixes
four concurrency regimes on purpose: asyncio
coroutines on the event loop, per-lane single-thread executors for
replans, a ``threading.Lock`` around cross-thread stats, and
``call_soon_threadsafe`` to resolve loop-owned futures from worker
threads.  That discipline is sound (DESIGN.md §8) but fragile under
maintenance — a stats counter bumped outside the lock or a replan
called straight from a coroutine corrupts tenants silently.  This pass
proves the discipline statically, pure-AST and stdlib-only.

The model, per module:

  * every function/method is a node in a **call graph** (``self.m()``
    and bare-name calls resolve within the module);
  * **loop context** seeds at every ``async def`` and every callback
    handed to ``call_soon``/``call_soon_threadsafe``/``call_later``/
    ``add_done_callback``; **worker context** seeds at every callable
    submitted to an executor (``run_in_executor``, ``Executor.submit``,
    ``asyncio.to_thread``, ``threading.Thread(target=...)``).  Contexts
    propagate through sync call edges, so a helper called from both
    sides carries both;
  * per class, attributes assigned in ``__init__`` form the **ownership
    map**: attributes classified as locks (``threading.Lock``/``RLock``
    vs ``asyncio.Lock`` — scalars or collections) and executors, the
    rest as candidate shared state.  Lock *regions* are the lexical
    bodies of ``with``/``async with`` whose context expression resolves
    to a lock attribute — through subscripts (``self._locks[lane]``)
    and local aliases (``lock = self._stats_lock``).

Rules:

  race-unguarded-shared    a mutable attribute touched from both loop
                           and worker context has an access site that
                           does not hold its owning lock (the lock held
                           at the majority of guarded sites)
  race-await-under-lock    ``await`` (incl. ``async with``/``async
                           for``, e.g. a lane-lock acquisition) while a
                           ``threading.Lock`` is held — the loop and
                           every contender stall until release
  loop-blocking-call       blocking work in loop context: ``time.sleep``,
                           ``Future.result()``, or a direct
                           ``Scheduler.submit/submit_many/update/...``
                           replan that bypasses the lane executor
  race-cross-thread-future ``set_result``/``set_exception`` called from
                           worker context — loop-owned futures resolve
                           only via ``call_soon_threadsafe``
  leak-executor            a ``ThreadPoolExecutor`` (class attribute or
                           local) that no method ever shuts down
  gc-task-ref              a ``create_task``/``ensure_future`` task that
                           is not strongly referenced (the loop keeps
                           only weak refs; a GC pass can drop it
                           mid-debounce)

Heuristics are deliberately name- and structure-based (a receiver is
"a Scheduler" if it is constructed from ``Scheduler(...)`` or named
``sched``/``scheduler``); a site that is correct by design carries an
``# analysis: allow[rule] reason`` pragma like every other pass.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .index import SourceFile

_Scope = Callable[[str], bool]

#: repo-mode scope: the async serving layer (extend the prefix list when
#: a new async/threaded package lands — the analyzer must grow with it)
_ASYNC_PKGS = ("src/repro_torch/service/",)


def _svc(rel: str) -> bool:
    return rel.startswith(_ASYNC_PKGS)


RULES: Dict[str, _Scope] = {
    "race-unguarded-shared": _svc,
    "race-await-under-lock": _svc,
    "loop-blocking-call": _svc,
    "race-cross-thread-future": _svc,
    "leak-executor": _svc,
    "gc-task-ref": _svc,
}

THREAD_LOCKS = frozenset({"Lock", "RLock"})
ASYNC_LOCKS = frozenset({"Lock", "Condition", "Semaphore", "BoundedSemaphore"})
EXECUTORS = frozenset({"ThreadPoolExecutor", "ProcessPoolExecutor"})
#: method names that mutate their receiver in place
MUTATORS = frozenset({
    "append", "add", "extend", "insert", "remove", "discard", "pop",
    "popitem", "clear", "update", "setdefault", "sort", "appendleft"})
#: blocking Scheduler session ops (replans) — loop code must route them
#: through the lane executor
SCHED_OPS = frozenset({"submit", "submit_many", "update", "probe_update",
                       "mark_failed", "degrade", "restore"})
SCHED_NAMES = frozenset({"sched", "scheduler", "_sched", "_scheduler"})
EXECUTOR_NAMES = frozenset({"ex", "executor", "pool", "_ex", "_executor"})
TASK_MAKERS = frozenset({"create_task", "ensure_future"})
ANCHOR_METHODS = frozenset({"add", "append", "insert"})
AWAITER_FUNCS = frozenset({"gather", "wait", "as_completed", "shield"})

LockId = Tuple[str, str]            # ("thread"|"async", attr-or-site key)


# ------------------------------------------------------------ small helpers

def _terminal_name(expr: ast.expr) -> Optional[str]:
    """The last identifier of a Name/Attribute/Subscript chain."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _self_attr(expr: ast.expr) -> Optional[str]:
    """``attr`` if ``expr`` is exactly ``self.attr``."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


def _self_root(expr: ast.expr) -> Optional[str]:
    """The attribute a chain is rooted at: ``self.X[...].m`` -> ``X``."""
    while True:
        attr = _self_attr(expr)
        if attr is not None:
            return attr
        if isinstance(expr, ast.Attribute):
            expr = expr.value
        elif isinstance(expr, (ast.Subscript, ast.Starred)):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        else:
            return None


def _resolve_local(expr: Optional[ast.expr], env: Dict[str, ast.expr]
                   ) -> Optional[ast.expr]:
    seen: Set[str] = set()
    while isinstance(expr, ast.Name) and expr.id in env \
            and expr.id not in seen:
        seen.add(expr.id)
        expr = env[expr.id]
    return expr


def _call_name(call: ast.Call) -> Optional[str]:
    """The called name: ``f(...)`` -> f, ``a.b.f(...)`` -> f."""
    return _terminal_name(call.func)


def _is_ctor(expr: Optional[ast.expr], names: FrozenSet[str],
             origins: Dict[str, str], module: str) -> bool:
    """Is ``expr`` a call constructing one of ``names`` (checked against
    the import origins when the name was imported from somewhere)?"""
    if not isinstance(expr, ast.Call):
        return False
    name = _call_name(expr)
    if name not in names:
        return False
    fn = expr.func
    if isinstance(fn, ast.Name):
        origin = origins.get(fn.id, "")
        return origin == "" or origin.startswith(module) or origin == fn.id
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        base = fn.value.id
        return origins.get(base, base).split(".")[0] == module.split(".")[0]
    return True


@dataclasses.dataclass
class _Func:
    node: ast.AST                    # FunctionDef | AsyncFunctionDef
    qname: str
    cls: Optional[ast.ClassDef]
    is_async: bool
    contexts: Set[str] = dataclasses.field(default_factory=set)
    edges: Set[int] = dataclasses.field(default_factory=set)   # callee ids
    accesses: List["_Access"] = dataclasses.field(default_factory=list)
    blocking: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    resolves: List[Tuple[int, str]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class _Access:
    attr: str
    line: int
    write: bool
    held: FrozenSet[LockId]


@dataclasses.dataclass
class _ClassInfo:
    node: ast.ClassDef
    init_attrs: Set[str] = dataclasses.field(default_factory=set)
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    executors: Dict[str, int] = dataclasses.field(default_factory=dict)
    methods: Dict[str, _Func] = dataclasses.field(default_factory=dict)


class _ModuleAnalysis:
    """One file's concurrency model: call graph, contexts, ownership."""

    def __init__(self, sf: SourceFile) -> None:
        self.sf = sf
        self.origins = sf.import_origins
        self.funcs: Dict[int, _Func] = {}          # id(node) -> _Func
        self.by_name: Dict[str, _Func] = {}        # bare-name resolution
        self.classes: List[_ClassInfo] = []
        self.loop_seeds: Set[int] = set()
        self.worker_seeds: Set[int] = set()
        self.findings: List[Finding] = []

    # -------------------------------------------------- registry building
    def build(self) -> None:
        for stmt in self.sf.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register(stmt, cls=None, prefix="")
            elif isinstance(stmt, ast.ClassDef):
                info = _ClassInfo(stmt)
                self.classes.append(info)
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        f = self._register(sub, cls=stmt,
                                           prefix=stmt.name + ".")
                        info.methods[sub.name] = f
                self._classify_attrs(info)
        for info in self.classes:
            self._find_executor_stores(info)

    def _register(self, node: ast.AST, cls: Optional[ast.ClassDef],
                  prefix: str) -> _Func:
        f = _Func(node=node, qname=prefix + node.name, cls=cls,
                  is_async=isinstance(node, ast.AsyncFunctionDef))
        self.funcs[id(node)] = f
        # module-level names win bare-name resolution; nested defs are
        # still reachable when their name is unique in the file
        if cls is None and (node.name not in self.by_name or not prefix):
            self.by_name[node.name] = f
        for sub in ast.walk(node):
            if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(sub) not in self.funcs:
                self._register(sub, cls=cls, prefix=f.qname + ".")
        return f

    def _classify_attrs(self, info: _ClassInfo) -> None:
        init = info.methods.get("__init__")
        if init is None:
            return
        for stmt in ast.walk(init.node):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(stmt, ast.Assign):
                targets, value = list(stmt.targets), stmt.value
            elif isinstance(stmt, ast.AnnAssign):
                targets, value = [stmt.target], stmt.value
            else:
                continue
            for tgt in targets:
                elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                for elt in elts:
                    attr = _self_attr(elt)
                    if attr is None:
                        continue
                    info.init_attrs.add(attr)
                    kind = self._lock_kind_of_value(value)
                    if kind is not None:
                        info.locks[attr] = kind
                    if value is not None and self._contains_executor(value):
                        info.executors.setdefault(attr, elt.lineno)

    def _lock_kind_of_value(self, value: Optional[ast.expr]
                            ) -> Optional[str]:
        """'thread' / 'async' if ``value`` constructs (or is a
        collection of) lock primitives."""
        if value is None:
            return None
        for node in ast.walk(value):
            if _is_ctor(node, THREAD_LOCKS, self.origins, "threading"):
                return "thread"
            if _is_ctor(node, ASYNC_LOCKS, self.origins, "asyncio"):
                return "async"
        return None

    def _contains_executor(self, value: ast.expr) -> bool:
        return any(_is_ctor(n, EXECUTORS, self.origins, "concurrent")
                   for n in ast.walk(value))

    def _find_executor_stores(self, info: _ClassInfo) -> None:
        """Executors created outside ``__init__`` and stored on self
        (the lazy-creation idiom) also count as executor attributes."""
        for f in info.methods.values():
            env = self.sf.assign_env(f.node)
            for stmt in ast.walk(f.node):
                if not isinstance(stmt, ast.Assign):
                    continue
                if not self._contains_executor_resolved(stmt.value, env):
                    continue
                for tgt in stmt.targets:
                    attr = _self_root(tgt)
                    if attr is not None:
                        info.executors.setdefault(attr, stmt.lineno)
                        info.init_attrs.add(attr)

    def _contains_executor_resolved(self, value: ast.expr,
                                    env: Dict[str, ast.expr]) -> bool:
        resolved = _resolve_local(value, env)
        return resolved is not None and self._contains_executor(resolved)

    # ------------------------------------------------------ function scans
    def scan_all(self) -> None:
        for f in list(self.funcs.values()):
            _FuncScan(self, f).scan()

    # ------------------------------------------------- context propagation
    def propagate(self) -> None:
        for f in self.funcs.values():
            if f.is_async:
                f.contexts.add("loop")
        for fid in self.loop_seeds:
            self.funcs[fid].contexts.add("loop")
        for fid in self.worker_seeds:
            self.funcs[fid].contexts.add("worker")
        changed = True
        while changed:
            changed = False
            for f in self.funcs.values():
                for callee_id in f.edges:
                    g = self.funcs.get(callee_id)
                    if g is None or g.is_async:
                        continue          # calling an async def makes a
                    for ctx in f.contexts:  # coroutine, not a transfer
                        if ctx not in g.contexts:
                            g.contexts.add(ctx)
                            changed = True

    # ------------------------------------------------------- rule evaluation
    def evaluate(self) -> List[Finding]:
        path = self.sf.display
        for f in self.funcs.values():
            if "loop" in f.contexts:
                for line, msg in f.blocking:
                    self.findings.append(Finding(
                        "loop-blocking-call", path, line, msg))
            if "worker" in f.contexts:
                for line, meth in f.resolves:
                    self.findings.append(Finding(
                        "race-cross-thread-future", path, line,
                        f"{meth}() called from worker context — a "
                        f"loop-owned future may only be resolved on its "
                        f"loop; route it through "
                        f"fut.get_loop().call_soon_threadsafe(...)"))
        for info in self.classes:
            self._evaluate_ownership(info)
            self._evaluate_executors(info)
        return self.findings

    def _evaluate_ownership(self, info: _ClassInfo) -> None:
        path = self.sf.display
        sites: Dict[str, List[Tuple[_Access, _Func]]] = {}
        for f in info.methods.values():
            if f.node.name == "__init__" or not f.contexts:
                continue
            for acc in f.accesses:
                if acc.attr in info.init_attrs \
                        and acc.attr not in info.locks:
                    sites.setdefault(acc.attr, []).append((acc, f))
        for attr in sorted(sites):
            recs = sites[attr]
            ctxs: Set[str] = set()
            for _, f in recs:
                ctxs |= f.contexts
            if not ({"loop", "worker"} <= ctxs):
                continue                  # single-regime attribute
            if not any(acc.write for acc, _ in recs):
                continue                  # never mutated post-init
            by_line: Dict[int, Tuple[_Access, _Func]] = {}
            for acc, f in recs:           # merge read+write at one line
                prev = by_line.get(acc.line)
                if prev is None or (acc.write and not prev[0].write):
                    by_line[acc.line] = (acc, f)
            guarded = [acc for acc, _ in by_line.values() if acc.held]
            owner: Optional[LockId] = None
            if guarded:
                counts: Dict[LockId, int] = {}
                for acc in guarded:
                    for lock in acc.held:
                        counts[lock] = counts.get(lock, 0) + 1
                owner = sorted(counts, key=lambda k: (-counts[k], k))[0]
            for line in sorted(by_line):
                acc, f = by_line[line]
                if owner is not None and owner in acc.held:
                    continue
                where = ("both loop and worker contexts"
                         if f.contexts >= {"loop", "worker"}
                         else "the event loop" if "loop" in f.contexts
                         else "a worker thread")
                if owner is None:
                    msg = (f"shared attribute self.{attr} is mutated "
                           f"across loop and worker threads but no "
                           f"access holds a lock — give it an owning "
                           f"lock and guard every site")
                else:
                    msg = (f"shared attribute self.{attr} accessed from "
                           f"{where} without its owning lock "
                           f"self.{owner[1]}")
                self.findings.append(Finding(
                    "race-unguarded-shared", path, line, msg))

    def _evaluate_executors(self, info: _ClassInfo) -> None:
        for attr in sorted(info.executors):
            joined = False
            for f in info.methods.values():
                has_shutdown = any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "shutdown"
                    for n in ast.walk(f.node))
                mentions = any(_self_attr(n) == attr
                               for n in ast.walk(f.node)
                               if isinstance(n, ast.Attribute))
                if has_shutdown and mentions:
                    joined = True
                    break
            if not joined:
                self.findings.append(Finding(
                    "leak-executor", self.sf.display, info.executors[attr],
                    f"ThreadPoolExecutor stored on self.{attr} is never "
                    f"shut down — join it in close() so worker threads "
                    f"cannot outlive the service"))


class _FuncScan:
    """One function's body walk: lock regions, accesses, call edges,
    entry registrations, and the lexical rules (2 and 6)."""

    def __init__(self, mod: _ModuleAnalysis, f: _Func) -> None:
        self.mod = mod
        self.f = f
        self.env = mod.sf.assign_env(f.node)
        self.held: List[LockId] = []

    # lock ids currently held, restricted to thread locks
    def _thread_locks(self) -> List[LockId]:
        return [lock for lock in self.held if lock[0] == "thread"]

    def scan(self) -> None:
        self._scan_stmts(self.f.node.body)
        self._scan_tasks()
        self._scan_local_executors()

    # ----------------------------------------------------------- statements
    def _scan_stmts(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt)

    def _scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                        # separate scan unit
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._scan_with(stmt)
            return
        if isinstance(stmt, ast.AsyncFor):
            self._rule2(stmt.lineno, "async for")
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for tgt in targets:
                for node in ast.walk(tgt):
                    attr = _self_attr(node) if isinstance(
                        node, ast.Attribute) else None
                    if attr is not None:
                        self._record(attr, node.lineno, write=True)
        # child expressions at this statement level
        for field, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self._scan_expr(value)
            elif isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self._scan_stmts(value)
                else:
                    for item in value:
                        if isinstance(item, ast.expr):
                            self._scan_expr(item)
                        elif isinstance(item, ast.excepthandler):
                            self._scan_stmts(item.body)
                        elif isinstance(item, ast.withitem):
                            pass          # handled in _scan_with
                        elif hasattr(item, "body") \
                                and isinstance(getattr(item, "body"),
                                               list):  # match cases
                            self._scan_stmts(item.body)

    def _scan_with(self, stmt: ast.stmt) -> None:
        acquired: List[LockId] = []
        for item in stmt.items:
            self._scan_expr(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                acquired.append(lock)
        if isinstance(stmt, ast.AsyncWith):
            self._rule2(stmt.lineno, "async with (lock acquisition)")
        self.held.extend(acquired)
        try:
            self._scan_stmts(stmt.body)
        finally:
            del self.held[len(self.held) - len(acquired):]

    def _lock_of(self, expr: ast.expr) -> Optional[LockId]:
        resolved = _resolve_local(expr, self.env)
        if resolved is None:
            return None
        while isinstance(resolved, ast.Subscript):
            resolved = _resolve_local(resolved.value, self.env)
        attr = _self_attr(resolved) if isinstance(resolved, ast.Attribute) \
            else None
        if attr is not None and self.f.cls is not None:
            info = next((c for c in self.mod.classes
                         if c.node is self.f.cls), None)
            if info is not None and attr in info.locks:
                return (info.locks[attr], attr)
        kind = self.mod._lock_kind_of_value(resolved) \
            if isinstance(resolved, ast.Call) else None
        if kind is not None:
            name = expr.id if isinstance(expr, ast.Name) \
                else f"line-{resolved.lineno}"
            return (kind, name)
        return None

    def _rule2(self, lineno: int, what: str) -> None:
        locks = self._thread_locks()
        if locks:
            self.mod.findings.append(Finding(
                "race-await-under-lock", self.mod.sf.display, lineno,
                f"{what} while holding threading lock "
                f"self.{locks[-1][1]} — the event loop and every "
                f"contender stall until it releases"))

    # ---------------------------------------------------------- expressions
    def _scan_expr(self, expr: ast.expr) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Await):
                self._rule2(node.lineno, "await")
            elif isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is not None:
                    self._record(attr, node.lineno,
                                 write=isinstance(node.ctx,
                                                  (ast.Store, ast.Del)))
            elif isinstance(node, ast.Call):
                self._scan_call(node)

    def _record(self, attr: str, lineno: int, write: bool) -> None:
        self.f.accesses.append(_Access(
            attr=attr, line=lineno, write=write,
            held=frozenset(self.held)))

    def _scan_call(self, call: ast.Call) -> None:
        fn = call.func
        name = _call_name(call)
        # in-place mutation of a self-rooted chain counts as a write
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATORS:
            root = _self_root(fn.value)
            if root is not None:
                self._record(root, call.lineno, write=True)
        # --- entry registrations -------------------------------------
        if name == "run_in_executor" and len(call.args) >= 2:
            self._mark_entry(call.args[1], "worker")
        elif name == "to_thread" and call.args:
            self._mark_entry(call.args[0], "worker")
        elif name == "submit" and isinstance(fn, ast.Attribute) \
                and self._executorish(fn.value) and call.args:
            self._mark_entry(call.args[0], "worker")
        elif name == "Thread" and _is_ctor(call, frozenset({"Thread"}),
                                           self.mod.origins, "threading"):
            for kw in call.keywords:
                if kw.arg == "target":
                    self._mark_entry(kw.value, "worker")
        elif name in ("call_soon", "call_soon_threadsafe") and call.args:
            self._mark_entry(call.args[0], "loop")
        elif name == "call_later" and len(call.args) >= 2:
            self._mark_entry(call.args[1], "loop")
        elif name == "add_done_callback" and call.args:
            self._mark_entry(call.args[0], "loop")
        # --- call edges ----------------------------------------------
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                callee = self._method(fn.attr)
                if callee is not None:
                    self.f.edges.add(id(callee.node))
        elif isinstance(fn, ast.Name):
            callee = self.mod.by_name.get(fn.id)
            if callee is not None:
                self.f.edges.add(id(callee.node))
        # --- rule 3: blocking candidates -----------------------------
        if isinstance(fn, ast.Attribute):
            if fn.attr == "sleep" and isinstance(fn.value, ast.Name) \
                    and self.mod.origins.get(fn.value.id,
                                             fn.value.id) == "time":
                self.f.blocking.append((
                    call.lineno,
                    "time.sleep blocks the event loop — use "
                    "await asyncio.sleep (or run it on an executor)"))
            elif fn.attr == "result" and not call.args:
                self.f.blocking.append((
                    call.lineno,
                    "Future.result() blocks the event loop until the "
                    "future resolves — await it instead"))
            elif fn.attr in SCHED_OPS and self._schedish(fn.value):
                self.f.blocking.append((
                    call.lineno,
                    f"Scheduler.{fn.attr} called from event-loop "
                    f"context — replans must run on a worker lane "
                    f"(run_in_executor), or the loop stalls for the "
                    f"whole replan"))
            # --- rule 4: cross-thread future resolution --------------
            if fn.attr in ("set_result", "set_exception"):
                recv = _terminal_name(fn.value) or "future"
                self.f.resolves.append((call.lineno,
                                        f"{recv}.{fn.attr}"))
        elif isinstance(fn, ast.Name) and fn.id == "sleep" \
                and self.mod.origins.get(fn.id) == "time.sleep":
            self.f.blocking.append((
                call.lineno,
                "time.sleep blocks the event loop — use "
                "await asyncio.sleep (or run it on an executor)"))

    def _method(self, name: str) -> Optional[_Func]:
        if self.f.cls is None:
            return None
        info = next((c for c in self.mod.classes
                     if c.node is self.f.cls), None)
        return info.methods.get(name) if info is not None else None

    def _mark_entry(self, expr: ast.expr, ctx: str) -> None:
        if isinstance(expr, ast.Call) and _call_name(expr) == "partial":
            if expr.args:
                self._mark_entry(expr.args[0], ctx)
            return
        target: Optional[_Func] = None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            target = self._method(expr.attr)
        elif isinstance(expr, ast.Name):
            resolved = _resolve_local(expr, self.env)
            if isinstance(resolved, ast.Name):
                target = self.mod.by_name.get(resolved.id)
            else:
                target = self.mod.by_name.get(expr.id)
        if target is not None:
            seeds = self.mod.worker_seeds if ctx == "worker" \
                else self.mod.loop_seeds
            seeds.add(id(target.node))

    def _executorish(self, recv: ast.expr) -> bool:
        resolved = _resolve_local(recv, self.env)
        if resolved is not None and self.mod._contains_executor(resolved):
            return True
        root = _self_root(recv)
        if root is not None and self.f.cls is not None:
            info = next((c for c in self.mod.classes
                         if c.node is self.f.cls), None)
            if info is not None and root in info.executors:
                return True
        name = _terminal_name(recv)
        return name in EXECUTOR_NAMES if name else False

    def _schedish(self, recv: ast.expr) -> bool:
        resolved = _resolve_local(recv, self.env)
        if isinstance(resolved, ast.Call) \
                and _call_name(resolved) == "Scheduler":
            return True
        name = _terminal_name(recv)
        return name in SCHED_NAMES if name else False

    # ------------------------------------------------------ rule 6: tasks
    def _scan_tasks(self) -> None:
        body_stmts = [s for s in ast.walk(self.f.node)
                      if isinstance(s, ast.stmt)]
        for stmt in body_stmts:
            if isinstance(stmt, ast.Expr) and self._task_call(stmt.value):
                self._flag_task(stmt.value.lineno)
            elif isinstance(stmt, ast.Assign) \
                    and self._task_call(stmt.value):
                if len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    if not self._anchored(stmt.targets[0].id):
                        self._flag_task(stmt.value.lineno)
                # attribute/subscript targets are themselves anchors

    def _task_call(self, expr: ast.expr) -> bool:
        return isinstance(expr, ast.Call) \
            and _call_name(expr) in TASK_MAKERS

    def _anchored(self, name: str) -> bool:
        for node in ast.walk(self.f.node):
            if isinstance(node, ast.Call):
                fn = node.func
                arg_names = [a.id for a in node.args
                             if isinstance(a, ast.Name)]
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in ANCHOR_METHODS \
                        and name in arg_names:
                    return True
                if _call_name(node) in AWAITER_FUNCS \
                        and name in arg_names:
                    return True
            elif isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name \
                        and any(isinstance(t, (ast.Attribute, ast.Subscript))
                                for t in node.targets):
                    return True
            elif isinstance(node, ast.Await):
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name:
                    return True
            elif isinstance(node, ast.Return):
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name:
                    return True
        return False

    def _flag_task(self, lineno: int) -> None:
        self.mod.findings.append(Finding(
            "gc-task-ref", self.mod.sf.display, lineno,
            "task is not strongly referenced — the event loop keeps "
            "only weak task refs, so a GC pass can drop it mid-flight; "
            "anchor it in a container until its done-callback discards "
            "it"))

    # ------------------------------------------- rule 5: local executors
    def _scan_local_executors(self) -> None:
        for stmt in ast.walk(self.f.node):
            if not isinstance(stmt, ast.Assign) \
                    or len(stmt.targets) != 1 \
                    or not isinstance(stmt.targets[0], ast.Name):
                continue
            if not _is_ctor(stmt.value, EXECUTORS, self.mod.origins,
                            "concurrent"):
                continue
            name = stmt.targets[0].id
            if not self._local_executor_escapes(name):
                self.mod.findings.append(Finding(
                    "leak-executor", self.mod.sf.display, stmt.lineno,
                    f"local ThreadPoolExecutor {name!r} is never shut "
                    f"down — use 'with {name}:' or call "
                    f"{name}.shutdown()"))

    def _local_executor_escapes(self, name: str) -> bool:
        for node in ast.walk(self.f.node):
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr == "shutdown" \
                        and isinstance(fn.value, ast.Name) \
                        and fn.value.id == name:
                    return True
                if any(isinstance(a, ast.Name) and a.id == name
                       for a in node.args):
                    return True           # handed to another owner
            elif isinstance(node, ast.withitem):
                ce = node.context_expr
                if isinstance(ce, ast.Name) and ce.id == name:
                    return True
            elif isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name \
                        and any(isinstance(t, (ast.Attribute, ast.Subscript))
                                for t in node.targets):
                    return True
            elif isinstance(node, ast.Return):
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name:
                    return True
        return False


def run(sf: SourceFile) -> List[Finding]:
    """All concurrency findings for one indexed file (scope-agnostic —
    the CLI applies repo-mode path scopes)."""
    mod = _ModuleAnalysis(sf)
    mod.build()
    mod.scan_all()
    mod.propagate()
    return mod.evaluate()

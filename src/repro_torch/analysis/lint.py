"""Bit-exactness & determinism lint (pure-AST, never imports the code).

Twin of ``repro.analysis.lint``, its seven rules scoped to the port's
paths.  The engine's contract is that the *decision layer* is exact
integer / comparison logic and every float op happens inside a backend
— that is what keeps the scalar, vector and cuda backends'
decisions bit-identical.  These rules encode that contract plus the
determinism hygiene the chaos and bit-identity tests rely on:

  float-arith         decision layer (engine.py / api.py) performs float
                      arithmetic outside backend calls
  sentinel-scope      fault sentinels referenced outside faults.py and
                      the engine masking point
  nondeterminism      time.time / unseeded legacy random in the
                      scheduling packages (core, service)
  set-iteration       direct iteration over a set (order is hash-seed
                      dependent) without sorted(...)
  deprecation-route   warnings.warn(DeprecationWarning) outside
                      deprecation.warn_once
  host-sync           a wait on the device in a backend outside the
                      documented one-fetch-per-dispatch sites: the
                      reference's ``device_get`` / ``block_until_ready``,
                      and their PyTorch counterparts, any
                      ``.synchronize()`` (``torch.cuda.synchronize``,
                      ``Event.synchronize``) and, in a module that
                      imports torch, ``.item()`` / ``.tolist()`` /
                      ``.cpu()`` / ``.numpy()`` (a copy to the host,
                      which waits for a tensor on the card; a NumPy-only
                      module has no device to wait for)
  unused-import       dead imports in the scheduling packages (excl.
                      __init__.py re-export surfaces)

Each rule carries a repo-mode path scope; in explicit-path (fixture)
mode every rule applies to every given file.
"""
from __future__ import annotations

import ast
import re
from typing import Callable, Dict, List, Set

from .findings import Finding
from .index import SourceFile

SENTINELS = frozenset({"DOWN_COMP", "DOWN_SPEED", "INFEASIBLE_EFT"})
FLOAT_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
             ast.FloorDiv, ast.Mod)
BANNED_TIME = frozenset({"time", "time_ns"})      # monotonic et al. fine
BANNED_RANDOM = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "seed", "getrandbits", "gauss", "normalvariate"})
LEGACY_NP_RANDOM = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "choice", "shuffle", "permutation", "uniform", "normal"})
HOST_SYNCS = frozenset({"device_get", "block_until_ready", "synchronize"})
#: copies to the host: a wait on the device where the tensor is on it
TORCH_FETCHES = frozenset({"item", "tolist", "cpu", "numpy"})
PKG = "src/repro_torch/"

_Scope = Callable[[str], bool]


def _in(prefix: str) -> _Scope:
    return lambda rel: rel.startswith(prefix)


def _core_not(*basenames: str) -> _Scope:
    return lambda rel: (rel.startswith(PKG + "core/")
                        and rel.rsplit("/", 1)[-1] not in basenames)


def _sched_pkgs(rel: str) -> bool:
    """The deterministic scheduling surface: the core engine AND the
    async serving layer on top of it (repro_torch.service) — both must
    stay reproducible for the chaos/bit-identity oracles to hold."""
    return rel.startswith((PKG + "core/", PKG + "service/"))


#: rule-id -> repo-mode scope predicate over repo-relative posix paths
RULES: Dict[str, _Scope] = {
    "float-arith": lambda rel: rel in (PKG + "core/engine.py",
                                       PKG + "core/api.py"),
    "sentinel-scope": _core_not("faults.py", "engine.py"),
    "nondeterminism": _sched_pkgs,
    "set-iteration": _sched_pkgs,
    "deprecation-route": lambda rel: (rel.startswith(PKG)
                                      and rel != PKG + "core/deprecation.py"),
    "host-sync": _in(PKG + "core/backends/"),
    "unused-import": lambda rel: (_sched_pkgs(rel)
                                  and rel.rsplit("/", 1)[-1] != "__init__.py"),
}


def _module_float_consts(tree: ast.Module) -> Set[str]:
    """Names bound at module level to a bare float literal."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, float):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _is_float_operand(node: ast.expr, float_names: Set[str]) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return True
    return isinstance(node, ast.Name) and node.id in float_names


def _check_float_arith(path: str, tree: ast.Module) -> List[Finding]:
    consts = _module_float_consts(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, FLOAT_OPS) \
                and (_is_float_operand(node.left, consts)
                     or _is_float_operand(node.right, consts)):
            out.append(Finding(
                "float-arith", path, node.lineno,
                "float arithmetic in the decision layer — move it into a "
                "backend, or justify the site with an allow pragma"))
    return out


def _check_sentinel_scope(path: str, tree: ast.Module) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in SENTINELS:
            name = node.id
        elif isinstance(node, ast.Attribute) and node.attr in SENTINELS:
            name = node.attr
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name in SENTINELS:
                    out.append(Finding(
                        "sentinel-scope", path, node.lineno,
                        f"sentinel {alias.name} imported outside faults.py "
                        f"and the engine masking point"))
            continue
        if name is not None:
            out.append(Finding(
                "sentinel-scope", path, node.lineno,
                f"sentinel {name} referenced outside faults.py and the "
                f"engine masking point"))
    return out


def _check_nondeterminism(path: str, tree: ast.Module) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            val = node.value
            if isinstance(val, ast.Name) and val.id == "time" \
                    and node.attr in BANNED_TIME:
                out.append(Finding(
                    "nondeterminism", path, node.lineno,
                    f"time.{node.attr} is wall-clock dependent — use "
                    f"time.monotonic/perf_counter for durations"))
            elif isinstance(val, ast.Name) and val.id == "random" \
                    and node.attr in BANNED_RANDOM:
                out.append(Finding(
                    "nondeterminism", path, node.lineno,
                    f"global random.{node.attr} depends on interpreter-wide "
                    f"state — use a seeded np.random.Generator"))
            elif isinstance(val, ast.Attribute) and val.attr == "random" \
                    and isinstance(val.value, ast.Name) \
                    and val.value.id in ("np", "numpy") \
                    and node.attr in LEGACY_NP_RANDOM:
                out.append(Finding(
                    "nondeterminism", path, node.lineno,
                    f"legacy np.random.{node.attr} uses the global "
                    f"RandomState — use np.random.default_rng(seed)"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "time" \
                and not (isinstance(node.func.value, ast.Name)
                         and node.func.value.id == "time"):
            # loop.time() / self._loop.time(): the asyncio event-loop
            # clock (time.time() itself is caught by the branch above)
            out.append(Finding(
                "nondeterminism", path, node.lineno,
                "event-loop clock read (.time()) — scheduling decisions "
                "must not depend on it; latency accounting needs a "
                "justified allow pragma"))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for alias in node.names:
                    if alias.name in BANNED_TIME:
                        out.append(Finding(
                            "nondeterminism", path, node.lineno,
                            f"from time import {alias.name} — wall-clock "
                            f"dependent"))
            elif node.module == "random":
                out.append(Finding(
                    "nondeterminism", path, node.lineno,
                    "importing from the global random module — use a "
                    "seeded np.random.Generator"))
    return out


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


def _check_set_iteration(path: str, tree: ast.Module) -> List[Finding]:
    out = []

    def flag(node: ast.expr) -> None:
        out.append(Finding(
            "set-iteration", path, node.lineno,
            "iteration order over a set is hash-seed dependent — wrap in "
            "sorted(...) to keep decisions reproducible"))

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_set_expr(node.iter):
            flag(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    flag(gen.iter)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple") and node.args \
                and _is_set_expr(node.args[0]):
            flag(node.args[0])
    return out


def _check_deprecation_route(path: str, tree: ast.Module) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        is_warn = (isinstance(fn, ast.Attribute) and fn.attr == "warn") or \
                  (isinstance(fn, ast.Name) and fn.id == "warn")
        if not is_warn:
            continue
        mentions = any(isinstance(sub, ast.Name)
                       and sub.id == "DeprecationWarning"
                       for arg in list(node.args)
                       + [kw.value for kw in node.keywords]
                       for sub in ast.walk(arg))
        if mentions:
            out.append(Finding(
                "deprecation-route", path, node.lineno,
                "DeprecationWarning raised directly — route through "
                "deprecation.warn_once so -W error CI stays quiet and the "
                "warning fires once per process"))
    return out


def _imports_torch(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and (node.module or "").split(".")[0] == "torch":
            return True
    return False


def _check_host_sync(path: str, tree: ast.Module) -> List[Finding]:
    syncs = HOST_SYNCS | (TORCH_FETCHES if _imports_torch(tree)
                          else frozenset())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in syncs:
            out.append(Finding(
                "host-sync", path, node.lineno,
                f"host sync {node.func.attr} in a backend — only the "
                f"documented one-per-wave transfer may block on the device"))
    return out


_WORD = re.compile(r"\w+")


def _check_unused_import(path: str, tree: ast.Module) -> List[Finding]:
    imported: Dict[str, int] = {}          # bound name -> lineno
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                imported[bound] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                imported[alias.asname or alias.name] = node.lineno

    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and not isinstance(node.ctx, ast.Store):
            used.add(node.id)
    # quoted annotations and __all__ keep a name alive
    for node in ast.walk(tree):
        ann = None
        if isinstance(node, ast.AnnAssign):
            ann = node.annotation
        elif isinstance(node, ast.arg):
            ann = node.annotation
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ann = node.returns
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            used.update(_WORD.findall(ann.value))
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__" \
                        and isinstance(node.value, (ast.List, ast.Tuple)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) \
                                and isinstance(elt.value, str):
                            used.add(elt.value)
    # string annotations anywhere (e.g. "CompiledInstance" under
    # TYPE_CHECKING) are covered above; plain docstrings are not scanned
    # so prose mentions cannot keep a dead import alive.
    return [Finding("unused-import", path, lineno,
                    f"import {name!r} is unused")
            for name, lineno in sorted(imported.items(), key=lambda kv: kv[1])
            if name not in used]


_CHECKS = {
    "float-arith": _check_float_arith,
    "sentinel-scope": _check_sentinel_scope,
    "nondeterminism": _check_nondeterminism,
    "set-iteration": _check_set_iteration,
    "deprecation-route": _check_deprecation_route,
    "host-sync": _check_host_sync,
    "unused-import": _check_unused_import,
}


def run(sf: SourceFile) -> List[Finding]:
    """All lint findings for one indexed file (scope-agnostic — the CLI
    applies repo-mode path scopes)."""
    out: List[Finding] = []
    for check in _CHECKS.values():
        out.extend(check(sf.display, sf.tree))
    return out

"""Protocol/typing gate for ``CandidateEvaluator`` backends (pure-AST).

Twin of ``repro.analysis.typing_gate``: it holds the port's backends
(``ScalarBackend``, ``VectorBackend``, ``CudaBackend``) to the port's
protocol in ``core/backends/base.py``.

A new backend that forgets ``evaluate_batch`` or renames a parameter
must fail at analysis time, not at the first scheduled wave.  The gate
parses ``backends/base.py`` for the protocol (abstract methods +
signatures) and checks every subclass found in the scanned files:

  protocol-missing     an abstract protocol method is not implemented
  protocol-signature   an overridden method's positional parameters
                       disagree with the protocol (extra trailing
                       parameters are fine only with defaults — callers
                       hold a base-typed reference)
  backend-name         a concrete backend lacks the ``name`` class
                       attribute the registry keys on

The gate is pure-AST and stdlib-only, so ``python -m
repro_torch.analysis`` needs neither torch nor a card.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional

from .findings import Finding
from .index import ProjectIndex

BASE_CLASS = "CandidateEvaluator"
_BACKENDS = "src/repro_torch/core/backends/"

_Scope = Callable[[str], bool]

RULES: Dict[str, _Scope] = {
    "protocol-missing":
        lambda rel: rel.startswith(_BACKENDS),
    "protocol-signature":
        lambda rel: rel.startswith(_BACKENDS),
    "backend-name":
        lambda rel: rel.startswith(_BACKENDS),
}


class _Method:
    def __init__(self, node: ast.FunctionDef) -> None:
        self.name = node.name
        self.args = [a.arg for a in node.args.args]
        self.n_defaults = len(node.args.defaults)
        self.abstract = any(
            (isinstance(d, ast.Name) and d.id == "abstractmethod")
            or (isinstance(d, ast.Attribute) and d.attr == "abstractmethod")
            for d in node.decorator_list)
        self.static = any(
            isinstance(d, ast.Name) and d.id == "staticmethod"
            for d in node.decorator_list)


def _methods(cls: ast.ClassDef) -> Dict[str, _Method]:
    return {n.name: _Method(n) for n in cls.body
            if isinstance(n, ast.FunctionDef)}


def _has_name_attr(cls: ast.ClassDef) -> bool:
    for node in cls.body:
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "name"
                   for t in node.targets):
                return True
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) \
                    and node.target.id == "name" and node.value is not None:
                return True
    return False


def _subclasses_of(classes: List[ast.ClassDef],
                   base: str) -> List[ast.ClassDef]:
    out = []
    for node in classes:
        if node.name != base:
            for b in node.bases:
                if (isinstance(b, ast.Name) and b.id == base) or \
                        (isinstance(b, ast.Attribute) and b.attr == base):
                    out.append(node)
                    break
    return out


def _find_base(index: ProjectIndex) -> Optional[ast.ClassDef]:
    for sf in index.files.values():
        for node in sf.classes:
            if node.name == BASE_CLASS:
                return node
    return None


def run(index: ProjectIndex) -> List[Finding]:
    """Cross-file pass over the shared index, which must include the
    file defining :data:`BASE_CLASS` for the gate to have a protocol to
    check against (otherwise: no findings)."""
    base_cls = _find_base(index)
    if base_cls is None:
        return []
    protocol = _methods(base_cls)
    out: List[Finding] = []

    for path, sf in index.files.items():
        for cls in _subclasses_of(sf.classes, BASE_CLASS):
            impl = _methods(cls)
            if not _has_name_attr(cls):
                out.append(Finding(
                    "backend-name", path, cls.lineno,
                    f"backend {cls.name} has no 'name' class attribute — "
                    f"the BACKENDS registry and Plan.fallback key on it"))
            for meth in protocol.values():
                if meth.abstract and meth.name not in impl:
                    out.append(Finding(
                        "protocol-missing", path, cls.lineno,
                        f"backend {cls.name} does not implement abstract "
                        f"protocol method {meth.name}"))
            for meth_name, got in impl.items():
                want = protocol.get(meth_name)
                if want is None:
                    continue
                if got.args[:len(want.args)] != want.args:
                    out.append(Finding(
                        "protocol-signature", path, cls.lineno,
                        f"{cls.name}.{meth_name}({', '.join(got.args)}) "
                        f"disagrees with the protocol signature "
                        f"({', '.join(want.args)})"))
                    continue
                extra = len(got.args) - len(want.args)
                if extra > got.n_defaults:
                    out.append(Finding(
                        "protocol-signature", path, cls.lineno,
                        f"{cls.name}.{meth_name} adds {extra} positional "
                        f"parameter(s) without defaults — callers hold a "
                        f"{BASE_CLASS}-typed reference and won't pass them"))
    return out

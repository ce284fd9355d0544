"""Shared per-file analysis index: one parse + symbol tables for all passes.

Twin of ``repro.analysis.index``.  A CUDA source (``.cu``) is indexed as
text (:class:`TextFile`, :meth:`ProjectIndex.load_text`): the kernel
pass tokenizes it, and its lines carry pragmas like a Python file's.

Every analyzer pass used to carry its own ``ast.parse`` and its own
little symbol helpers; with a fourth pass (``concurrency``) that cost
would be paid four times per file.  :class:`ProjectIndex` centralizes
it: each file is read and parsed **exactly once** (``parse_count`` is
test-pinned), and the derived tables the passes share — function map,
class list, assignment environments — are computed lazily on the
:class:`SourceFile` and cached, so kernels/lint/typing-gate/concurrency
all consume the same objects.

The tables deliberately mirror the historical helpers' semantics (e.g.
:meth:`SourceFile.assign_env` is the kernel pass's flat
last-assignment-wins scan, nested statements included) so the refactor
is behavior-preserving: the passes produce byte-identical findings.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus lazily-built shared symbol tables."""

    path: Path
    display: str               # path as reported in findings
    text: str
    lines: List[str]
    tree: ast.Module
    _functions: Optional[Dict[str, ast.FunctionDef]] = None
    _classes: Optional[List[ast.ClassDef]] = None
    _assign_envs: Optional[Dict[int, Dict[str, ast.expr]]] = None
    _import_origins: Optional[Dict[str, str]] = None

    @property
    def functions(self) -> Dict[str, ast.FunctionDef]:
        """name -> (sync) FunctionDef, whole file, nested included
        (last definition wins — the kernel pass's resolution order)."""
        if self._functions is None:
            self._functions = {
                node.name: node for node in ast.walk(self.tree)
                if isinstance(node, ast.FunctionDef)}
        return self._functions

    @property
    def classes(self) -> List[ast.ClassDef]:
        """Every ClassDef in the file, in AST walk order."""
        if self._classes is None:
            self._classes = [node for node in ast.walk(self.tree)
                             if isinstance(node, ast.ClassDef)]
        return self._classes

    def assign_env(self, scope: Optional[ast.AST] = None
                   ) -> Dict[str, ast.expr]:
        """name -> value for single-target Name assignments under
        ``scope`` (default: the module), nested statements included,
        last assignment wins.  Cached per scope."""
        scope = scope if scope is not None else self.tree
        if self._assign_envs is None:
            self._assign_envs = {}
        cached = self._assign_envs.get(id(scope))
        if cached is None:
            cached = {}
            for node in ast.walk(scope):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    cached[node.targets[0].id] = node.value
            self._assign_envs[id(scope)] = cached
        return cached

    @property
    def import_origins(self) -> Dict[str, str]:
        """bound name -> dotted origin (``"threading.Lock"``,
        ``"asyncio"``, ...) for every import in the file."""
        if self._import_origins is None:
            origins: Dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        bound = alias.asname or alias.name.split(".")[0]
                        origins[bound] = alias.name
                elif isinstance(node, ast.ImportFrom):
                    mod = node.module or ""
                    for alias in node.names:
                        if alias.name == "*":
                            continue
                        origins[alias.asname or alias.name] = \
                            f"{mod}.{alias.name}" if mod else alias.name
            self._import_origins = origins
        return self._import_origins


@dataclasses.dataclass
class TextFile:
    """One source file that is not Python (a ``.cu``), read once."""

    path: Path
    display: str
    text: str
    lines: List[str]


class ProjectIndex:
    """All files of one analyzer invocation, each parsed exactly once.

    ``load`` returns the cached :class:`SourceFile` on a repeated path,
    so no matter how many passes (or how many times one pass) ask for a
    file, ``parse_count`` equals the number of distinct files.
    Unreadable/unparsable files land in ``errors`` (the CLI turns those
    into exit code 2) and are not retried.
    """

    def __init__(self) -> None:
        self.files: Dict[str, SourceFile] = {}     # display -> SourceFile
        self.texts: Dict[str, TextFile] = {}       # display -> TextFile
        self.errors: List[str] = []
        self.parse_count = 0
        self._failed: set = set()

    def load(self, path: Path, display: str) -> Optional[SourceFile]:
        sf = self.files.get(display)
        if sf is not None:
            return sf
        if display in self._failed:
            return None
        try:
            text = path.read_text(encoding="utf-8")
        except OSError as e:
            self.errors.append(f"cannot read {path}: {e}")
            self._failed.add(display)
            return None
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            self.errors.append(f"{path}:{e.lineno}: syntax error: {e.msg}")
            self._failed.add(display)
            return None
        self.parse_count += 1
        sf = SourceFile(path=path, display=display, text=text,
                        lines=text.splitlines(), tree=tree)
        self.files[display] = sf
        return sf

    def load_text(self, path: Path, display: str) -> Optional[TextFile]:
        """A non-Python source by its display name, read once; a file
        that cannot be read lands in ``errors``."""
        tf = self.texts.get(display)
        if tf is not None or display in self._failed:
            return tf
        try:
            text = path.read_text(encoding="utf-8")
        except OSError as e:
            self.errors.append(f"cannot read {path}: {e}")
            self._failed.add(display)
            return None
        tf = TextFile(path=path, display=display, text=text,
                      lines=text.splitlines())
        self.texts[display] = tf
        return tf

    def trees(self) -> List[Tuple[str, ast.Module]]:
        """``(display, tree)`` pairs in load order (the cross-file
        passes' iteration surface)."""
        return [(sf.display, sf.tree) for sf in self.files.values()]

"""Kernel invariant checker for the port's CUDA kernels — pure-AST over
the Python bindings and a token pass over the ``.cu`` sources; nothing
is compiled, loaded or launched.

The port's kernels are CUDA C++ libraries built by ``_nvcc.build(name,
[SOURCE], FLAGS)`` and called through ``ctypes``.  ``ctypes`` checks
nothing against the C function: an ``argtypes`` list one entry short,
or a ``c_int`` where the function takes a ``double``, passes garbage
silently.  And the scheduling kernels' decisions equal the scalar
backend's only if no multiply and add is fused and every rounding step
is the reference's.  The rules:

  ctypes-arity      every ``argtypes`` assignment, on ``lib.<fn>`` or on
                    an alias ``fn = built.lib.<fn>``, folds (list
                    arithmetic over constant lists and module aliases
                    such as ``_P = ctypes.c_void_p``) to as many entries
                    as the ``extern "C"`` function of that name in the
                    source the library is built from has parameters; an
                    expression or a target the pass cannot resolve is a
                    finding, not a pass
  ctypes-type       each entry's kind matches its parameter
                    (``c_void_p`` for a pointer or stream, ``c_int`` for
                    ``int``, ``c_double`` for ``double``, ``c_size_t`` for
                    ``size_t``, ...), and ``restype`` the return type
                    (unset means ``c_int``)
  cuda-rounding     in every source of a library built with
                    ``--fmad=false``, a ``+ - * /`` (or ``+= -= *= /=``)
                    with a floating-point operand outside the
                    ``__dadd_rn``/``__dsub_rn``/``__dmul_rn``/``__ddiv_rn``
                    intrinsics (``__fadd_rn``/``__fsub_rn``/``__fmul_rn``/
                    ``__fdiv_rn`` in float), and any ``fma``/``__fma_rn``;
                    integer index arithmetic is not (the pass tracks
                    declarations of ``double``, ``float`` and of every
                    template type parameter, the kernels' real type, per
                    scope, struct fields and functions returning one)
  cuda-fmad-flag    a library whose source rounds with those intrinsics
                    (the bit-exact contract) is built with
                    ``--fmad=false``, and a library whose source does not
                    is built without it
  kernel-rtol-site  ``F32_NEAR_TIE_RTOL`` may be defined, never consumed
                    (the reference's rule as it is: the near-tie band
                    documents tests, decisions must not branch on it)

The reference's kernel pass (``repro.analysis.kernels``) proves the
structure of Pallas kernels, which the port does not have; its rules
with no counterpart here, and why:

  kernel-carried-race, kernel-carried-uncommitted
                    a revisited ``BlockSpec`` output block committed once
                    per grid step; a CUDA kernel has no block specs, and
                    the scheduling kernels carry state in registers and
                    shared memory within one launch
  kernel-grid-carry a carry confined to the innermost sequential grid
                    axis; a CUDA grid has no sequential axis (the plan
                    kernel runs one alpha per block, each independent)
  kernel-tile-pad   ``pad_dim`` to the f32 TPU tile (8, 128); Hopper has
                    no such tile, and the port has no ``pad_dim``
  kernel-dtype      dtype from the refs, never literals, so the f32/f64
                    switch is one site; the port's scheduling kernels are
                    templates over their real type, instantiated in both,
                    and the binding picks the entry point by the tables'
                    dtype (``cuda-rounding`` covers both instantiations)
  kernel-arity      kernel refs equal to ``in_specs`` + ``out_specs``;
                    its counterpart is ``ctypes-arity``
  scan-carry-race, scan-carry-uncommitted
                    the ``lax.scan`` carry bound once per step; the port
                    has no ``lax.scan`` (the plan kernel's loop is C++)
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .index import ProjectIndex, SourceFile

RTOL_NAME = "F32_NEAR_TIE_RTOL"
FMAD_OFF = frozenset({"--fmad=false", "-fmad=false"})
PKG = "src/repro_torch/"

_Scope = Callable[[str], bool]

RULES: Dict[str, _Scope] = {
    "ctypes-arity": lambda rel: rel.startswith(PKG),
    "ctypes-type": lambda rel: rel.startswith(PKG),
    "cuda-rounding": lambda rel: rel.startswith(PKG),
    "cuda-fmad-flag": lambda rel: rel.startswith(PKG),
    "kernel-rtol-site": lambda rel: rel.startswith(PKG),
}

#: C parameter / return kinds -> the ctypes names that pass them
C_KINDS: Dict[str, Tuple[str, ...]] = {
    "pointer": ("c_void_p",),
    "int": ("c_int", "c_int32"),
    "unsigned": ("c_uint", "c_uint32"),
    "long long": ("c_longlong", "c_int64"),
    "unsigned long long": ("c_ulonglong", "c_uint64"),
    "size_t": ("c_size_t",),
    "double": ("c_double",),
    "float": ("c_float",),
    "bool": ("c_bool",),
    "void": (),
}
_CTYPES = frozenset(n for names in C_KINDS.values() for n in names)
#: intrinsics that round one f64 or f32 operation explicitly
ROUNDED = re.compile(r"__[df](add|sub|mul|div)_r[nzud]$")
FUSED = re.compile(r"(fma|fmaf|__fmaf?_r[nzud])$")
#: the floating-point types; a source's template type parameters join
#: them (the kernels' real type)
REAL_TYPES = frozenset({"double", "float"})
#: functions the pass knows return a floating-point value besides those
#: the source declares
DOUBLE_FUNCS = frozenset({"sqrt", "exp", "log", "fabs", "fmax", "fmin",
                          "pow", "floor", "ceil", "rint", "sqrtf", "expf",
                          "logf", "fabsf", "fmaxf", "fminf", "powf",
                          "floorf", "ceilf", "rintf", "__expf", "__logf",
                          "__shfl_sync", "__shfl_xor_sync",
                          "__shfl_down_sync"})
_QUALIFIERS = frozenset({"const", "volatile", "__restrict__", "restrict",
                         "static", "__shared__", "__device__",
                         "__constant__", "register"})
_KEYWORDS = frozenset({"return", "if", "else", "for", "while", "do",
                       "switch", "case", "sizeof", "new", "delete",
                       "throw", "goto", "typedef", "struct", "class",
                       "template", "typename", "using", "namespace",
                       "default", "break", "continue"}) | _QUALIFIERS


# ============================================================== C tokens
_TOKEN = re.compile(r"""
    (?P<str>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[fFuUlL]*|0[xX][0-9a-fA-F]+[uUlL]*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op><<=|>>=|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|%=
          |&=|\|=|\^=|::|[-+*/%<>=!&|^~?:;,.(){}\[\]\#])
""", re.VERBOSE)


def _strip(text: str) -> str:
    """``text`` with comments and preprocessor lines blanked out, every
    newline kept (so token lines stay the source's)."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("\n" * text.count("\n", i, j))
            i = j
        elif text[i] in "\"'":
            m = _TOKEN.match(text, i)
            j = m.end() if m and m.group("str") else i + 1
            out.append(text[i:j])
            i = j
        else:
            out.append(text[i])
            i += 1
    lines = "".join(out).split("\n")
    return "\n".join("" if ln.lstrip().startswith("#") else ln
                     for ln in lines)


def _tokens(text: str) -> List[Tuple[str, str, int]]:
    """(kind, text, line) of every token of a C/C++ source."""
    src = _strip(text)
    out: List[Tuple[str, str, int]] = []
    line, pos = 1, 0
    for m in _TOKEN.finditer(src):
        line += src.count("\n", pos, m.start())
        pos = m.start()
        out.append((m.lastgroup or "op", m.group(), line))
    return out


def _match(toks, i: int, step: int) -> int:
    """Index of the bracket matching the one at ``i``, searching in
    direction ``step`` (+1 forward from an opener, -1 back from a
    closer)."""
    pairs = {"(": ")", "[": "]", "{": "}", ")": "(", "]": "[", "}": "{"}
    open_, close = toks[i][1], pairs[toks[i][1]]
    depth = 0
    while 0 <= i < len(toks):
        t = toks[i][1]
        if t == open_:
            depth += 1
        elif t == close:
            depth -= 1
            if depth == 0:
                return i
        i += step
    return -1


# ====================================================== extern "C" parse
class CFunc:
    """One ``extern "C"`` function: its return kind and parameters."""

    def __init__(self, name: str, ret: str, params: List[str],
                 line: int) -> None:
        self.name, self.ret, self.params, self.line = name, ret, params, line


def _kind(type_tokens: Sequence[str]) -> str:
    """A parameter's or return type's kind (a key of ``C_KINDS``, or the
    type's own words when the pass does not know it)."""
    if "*" in type_tokens or "[" in type_tokens or "&" in type_tokens:
        return "pointer"
    words = [t for t in type_tokens if t not in _QUALIFIERS
             and t not in ("extern", "inline", "__host__", "__forceinline__",
                           "__global__", "signed")]
    norm = " ".join(words)
    aliases = {"unsigned int": "unsigned", "long long int": "long long",
               "int64_t": "long long", "uint64_t": "unsigned long long",
               "int32_t": "int", "uint32_t": "unsigned",
               "cudaError_t": "int"}
    return aliases.get(norm, norm)


def _split_params(toks) -> List[List[str]]:
    params, cur, depth = [], [], 0
    for _, t, _ in toks:
        if t in "([<":
            depth += 1
        elif t in ")]>":
            depth -= 1
        if t == "," and depth == 0:
            params.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        params.append(cur)
    if params == [["void"]]:
        return []
    return params


def _param_kind(words: List[str]) -> str:
    if "*" in words or "[" in words or "&" in words:
        return "pointer"
    # drop the parameter's name (the last identifier) when a type precedes
    body = words[:-1] if len(words) > 1 and re.match(
        r"[A-Za-z_]\w*$", words[-1]) and words[-1] not in C_KINDS \
        and words[-1] not in ("int", "double", "float", "long", "unsigned",
                              "size_t", "bool") else words
    return _kind(body)


def extern_c_functions(text: str) -> Dict[str, CFunc]:
    """Every function an ``extern "C"`` declaration or block of the
    source defines or declares, by name."""
    toks = _tokens(text)
    out: Dict[str, CFunc] = {}
    i = 0
    while i < len(toks):
        if toks[i][1] == "extern" and i + 1 < len(toks) \
                and toks[i + 1][1] == '"C"':
            j = i + 2
            if j < len(toks) and toks[j][1] == "{":
                end = _match(toks, j, 1)
                _functions_in(toks[j + 1:end], out)
                i = end + 1
                continue
            # one declaration: up to its body or its ';'
            k = j
            while k < len(toks) and toks[k][1] not in ("{", ";"):
                k += 1
            _functions_in(toks[j:k] + [("op", ";", 0)], out)
            i = k + 1
            continue
        i += 1
    return out


def _functions_in(toks, out: Dict[str, CFunc]) -> None:
    """Function definitions / prototypes at the top level of ``toks``."""
    start, i = 0, 0
    while i < len(toks):
        t = toks[i][1]
        if t == "(" and i > start and toks[i - 1][0] == "id":
            close = _match(toks, i, 1)
            name = toks[i - 1][1]
            ret = [x[1] for x in toks[start:i - 1]]
            params = [_param_kind(p) for p in _split_params(
                toks[i + 1:close])]
            out[name] = CFunc(name, _kind(ret), params, toks[i - 1][2])
            k = close + 1
            while k < len(toks) and toks[k][1] not in ("{", ";"):
                k += 1
            if k < len(toks) and toks[k][1] == "{":
                k = _match(toks, k, 1)
            start = i = k + 1
            continue
        if t in (";", "}"):
            start = i + 1
        i += 1


# ======================================================= cuda-rounding
class _Scopes:
    """Floating-point declarations of a C++ source, by brace scope: a
    name is a ``scalar``, a ``ptr`` or an ``array`` of a real type
    (``double``, ``float`` or a template type parameter)."""

    def __init__(self, reals: Set[str]) -> None:
        self.stack: List[Dict[str, str]] = [{}]
        self.pending: Dict[str, str] = {}
        self.fields: Dict[str, Set[str]] = {}
        self.funcs: Set[str] = set(DOUBLE_FUNCS)
        self.reals = reals

    def kind(self, name: str) -> Optional[str]:
        for scope in reversed(self.stack):
            if name in scope:
                return scope[name]
        return self.pending.get(name)


def _template_types(toks) -> Set[str]:
    """The names of every template type parameter of a source
    (``template <typename F, ...>``): each may be the kernels' real
    type, so the pass treats each as one."""
    out: Set[str] = set()
    for i, (_, t, _) in enumerate(toks):
        if t != "template" or i + 1 >= len(toks) or toks[i + 1][1] != "<":
            continue
        depth, k = 0, i + 1
        while k < len(toks):
            w = toks[k][1]
            if w == "<":
                depth += 1
            elif w == ">":
                depth -= 1
                if depth == 0:
                    break
            elif w == ">>":
                depth -= 2
                if depth <= 0:
                    break
            elif w in ("typename", "class") and k + 1 < len(toks) \
                    and toks[k + 1][0] == "id":
                out.add(toks[k + 1][1])
            k += 1
    return out


def _declare(toks, i: int, sc: _Scopes, paren: int,
             in_struct: bool) -> None:
    """Declarators after the real type at ``i``."""
    j = i + 1
    while True:
        stars = 0
        while j < len(toks) and toks[j][1] in _QUALIFIERS | {"*", "&"}:
            stars += toks[j][1] == "*"
            j += 1
        if j >= len(toks) or toks[j][0] != "id":
            return
        name = toks[j][1]
        nxt = toks[j + 1][1] if j + 1 < len(toks) else ""
        if nxt == "(" and stars == 0 and paren == 0:
            sc.funcs.add(name)                   # a function of a real
            return
        kind = "ptr" if stars else ("array" if nxt == "[" else "scalar")
        (sc.pending if paren else sc.stack[-1])[name] = kind
        if in_struct:
            sc.fields.setdefault(name, set()).add(kind)
        # skip the initializer to the next declarator
        k, depth = j + 1, 0
        while k < len(toks):
            t = toks[k][1]
            if t in "([{":
                depth += 1
            elif t in ")]}":
                if depth == 0:
                    return
                depth -= 1
            elif depth == 0 and t in (";",):
                return
            elif depth == 0 and t == ",":
                break
            k += 1
        if k >= len(toks) or paren:              # a parameter list's ','
            return
        j = k + 1


def _is_double_literal(tok: str) -> bool:
    """A floating-point literal, double (``1.0``) or float (``1.0f``)."""
    return bool(re.match(r"(\d+\.\d*|\.\d+|\d+[eE])", tok)) \
        and not tok.lower().startswith("0x")


def _member_chain_end(toks, i: int) -> bool:
    return i > 0 and toks[i - 1][1] in (".", "->")


def _name_is_double(toks, i: int, sc: _Scopes, subscripted: bool) -> bool:
    """Whether the identifier at ``i`` (a member when a ``.``/``->``
    precedes it) denotes a double, subscripted or not."""
    name = toks[i][1]
    if _member_chain_end(toks, i):
        kinds = sc.fields.get(name)
        if not kinds:
            return False
        want = {"ptr", "array"} if subscripted else {"scalar"}
        return kinds <= want
    kind = sc.kind(name)
    return kind in (("ptr", "array") if subscripted else ("scalar",))


def _left_double(toks, i: int, sc: _Scopes) -> bool:
    """Whether the operand that ends just before ``i`` is a double."""
    j = i - 1
    if j < 0:
        return False
    kind, t, _ = toks[j]
    if t == "]":
        o = _match(toks, j, -1)
        return o > 0 and toks[o - 1][0] == "id" and \
            _name_is_double(toks, o - 1, sc, True)
    if t == ")":
        o = _match(toks, j, -1)
        if o > 0 and toks[o - 1][0] == "id" and \
                toks[o - 1][1] not in _KEYWORDS:
            # a call of a real function, or a functional cast F(...)
            return toks[o - 1][1] in sc.funcs or toks[o - 1][1] in sc.reals
        return _group_double(toks, o + 1, j, sc)
    if kind == "num":
        return _is_double_literal(t)
    if kind == "id":
        return _name_is_double(toks, j, sc, False)
    return False


def _right_double(toks, i: int, sc: _Scopes) -> bool:
    """Whether the operand that starts just after ``i`` is a double."""
    j = i + 1
    while j < len(toks) and toks[j][1] in ("-", "+", "!", "~", "*", "&"):
        j += 1
    if j >= len(toks):
        return False
    kind, t, _ = toks[j]
    if t == "(":
        c = _match(toks, j, 1)
        inner = [x[1] for x in toks[j + 1:c]]
        if inner and all(w in _QUALIFIERS or w in sc.reals for w in inner) \
                and any(w in sc.reals for w in inner):
            return True                          # a cast to a real type
        return _group_double(toks, j + 1, c, sc)
    if kind == "num":
        return _is_double_literal(t)
    if kind != "id" or t in _KEYWORDS:
        return False
    # follow a member chain a.b->c to its last name
    while j + 2 < len(toks) and toks[j + 1][1] in (".", "->") \
            and toks[j + 2][0] == "id":
        j += 2
    nxt = toks[j + 1][1] if j + 1 < len(toks) else ""
    if nxt == "(":
        # a call of a real function, or a functional cast F(...)
        return toks[j][1] in sc.funcs or toks[j][1] in sc.reals
    return _name_is_double(toks, j, sc, nxt == "[")


def _group_double(toks, a: int, b: int, sc: _Scopes) -> bool:
    """Whether a parenthesized expression ``toks[a:b]`` computes a
    double: it holds a double operand at its own level."""
    k = a
    while k < b:
        kind, t, _ = toks[k]
        if t in ("(", "["):
            c = _match(toks, k, 1)
            if t == "(" and k > a and toks[k - 1][0] == "id":
                if toks[k - 1][1] in sc.funcs or toks[k - 1][1] in sc.reals:
                    return True
            elif t == "(" and _group_double(toks, k + 1, c, sc):
                return True
            k = c + 1
            continue
        if kind == "num" and _is_double_literal(t):
            return True
        if kind == "id" and t not in _KEYWORDS:
            nxt = toks[k + 1][1] if k + 1 < b else ""
            if nxt not in ("(", ".", "->") and \
                    _name_is_double(toks, k, sc, nxt == "["):
                return True
        k += 1
    return False


_BINARY_AFTER = ("id", "num")


def _is_binary(toks, i: int) -> bool:
    """Whether the ``+ - * /`` at ``i`` is a binary operator."""
    if i == 0:
        return False
    kind, t, _ = toks[i - 1]
    if t in (")", "]", "++", "--"):
        if t == ")":                             # not after a cast
            o = _match(toks, i - 1, -1)
            inner = [x[1] for x in toks[o + 1:i - 1]]
            if inner and all(w in _QUALIFIERS or w in C_KINDS or w in (
                    "double", "float", "int", "long", "unsigned", "*")
                    for w in inner):
                return False
        return True
    return kind in _BINARY_AFTER and t not in _KEYWORDS and \
        t not in ("double", "float", "int", "long", "unsigned", "size_t",
                  "bool", "void", "char", "auto")


def rounding_findings(path: str, text: str) -> List[Finding]:
    """``cuda-rounding`` over one CUDA source."""
    toks = _tokens(text)
    sc = _Scopes(set(REAL_TYPES) | _template_types(toks))
    out: List[Finding] = []
    paren = 0
    struct_next = False
    struct_depth: List[bool] = []
    for i, (kind, t, line) in enumerate(toks):
        if t == "(":
            paren += 1
        elif t == ")":
            paren -= 1
        elif t == "struct":
            struct_next = True
        elif t == "{":
            sc.stack.append(dict(sc.pending))
            sc.pending = {}
            struct_depth.append(struct_next)
            struct_next = False
        elif t == "}":
            if len(sc.stack) > 1:
                sc.stack.pop()
            if struct_depth:
                struct_depth.pop()
        elif t == ";" and paren == 0:
            sc.pending = {}
            struct_next = False
        elif t in sc.reals:
            _declare(toks, i, sc, paren, bool(struct_depth and
                                              struct_depth[-1]))
        elif kind == "id" and FUSED.match(t) and i + 1 < len(toks) \
                and toks[i + 1][1] == "(":
            out.append(Finding(
                "cuda-rounding", path, line,
                f"{t}() fuses a multiply and an add — the reference rounds "
                f"each: use __dmul_rn then __dadd_rn (__fmul_rn then "
                f"__fadd_rn in float)"))
        elif t in ("+", "-", "*", "/", "+=", "-=", "*=", "/="):
            if len(t) == 1 and not _is_binary(toks, i):
                continue
            if _left_double(toks, i, sc) or _right_double(toks, i, sc):
                op = {"+": "add", "-": "sub", "*": "mul", "/": "div"}[t[0]]
                out.append(Finding(
                    "cuda-rounding", path, line,
                    f"bare floating-point '{t}' in a library built with "
                    f"--fmad=false — write the rounding step as "
                    f"__d{op}_rn (double) or __f{op}_rn (float)"))
    return out


def uses_rounded_intrinsics(text: str) -> bool:
    return any(kind == "id" and ROUNDED.match(t)
               for kind, t, _ in _tokens(text))


# ===================================================== Python bindings
class _Build:
    """One ``_nvcc.build(name, [sources], flags)`` call."""

    def __init__(self, call: ast.Call, sources: List[Path],
                 flags: Optional[Set[str]]) -> None:
        self.call, self.sources, self.flags = call, sources, flags


def _is_build(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or len(node.args) < 3:
        return False
    fn = node.func
    return (isinstance(fn, ast.Attribute) and fn.attr == "build") or \
        (isinstance(fn, ast.Name) and fn.id == "build")


def _resolve(node: Optional[ast.expr], env: Dict[str, ast.expr]
             ) -> Optional[ast.expr]:
    seen: Set[str] = set()
    while isinstance(node, ast.Name) and node.id in env \
            and node.id not in seen:
        seen.add(node.id)
        node = env[node.id]
    return node


def _path(node: Optional[ast.expr], env: Dict[str, ast.expr],
          here: Path) -> Optional[Path]:
    """A path expression over ``Path(__file__)``: ``.resolve()``,
    ``.parent``, ``.parents[k]`` and ``/ "name"``."""
    node = _resolve(node, env)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        base = _path(node.left, env, here)
        right = _resolve(node.right, env)
        if base is None or not (isinstance(right, ast.Constant)
                                and isinstance(right.value, str)):
            return None
        return base / right.value
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "Path" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id == "__file__":
                return here
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return Path(arg.value)
            return None
        if isinstance(fn, ast.Attribute) and fn.attr in ("resolve",
                                                         "absolute"):
            return _path(fn.value, env, here)
        return None
    if isinstance(node, ast.Attribute) and node.attr == "parent":
        base = _path(node.value, env, here)
        return None if base is None else base.parent
    if isinstance(node, ast.Subscript) and isinstance(node.value,
                                                      ast.Attribute) \
            and node.value.attr == "parents":
        base = _path(node.value.value, env, here)
        k = node.slice
        if base is None or not (isinstance(k, ast.Constant)
                                and isinstance(k.value, int)):
            return None
        return base.parents[k.value]
    return None


def _strings(node: Optional[ast.expr], env: Dict[str, ast.expr]
             ) -> Set[str]:
    """The string constants a flags expression is built from (names
    resolved; an opaque part such as ``_nvcc.BASE_FLAGS`` adds none)."""
    node = _resolve(node, env)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        return set().union(*(_strings(e, env) for e in node.elts)) \
            if node.elts else set()
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _strings(node.left, env) | _strings(node.right, env)
    return set()


def _ctypes_name(node: Optional[ast.expr], env: Dict[str, ast.expr]
                 ) -> Optional[str]:
    node = _resolve(node, env)
    if isinstance(node, ast.Attribute) and node.attr in _CTYPES:
        return node.attr
    if isinstance(node, ast.Name) and node.id in _CTYPES:
        return node.id
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    return None


def _fold(node: Optional[ast.expr], env: Dict[str, ast.expr]
          ) -> Optional[List[str]]:
    """An ``argtypes`` expression as its list of ctypes names, or None
    when it does not fold."""
    node = _resolve(node, env)
    if isinstance(node, (ast.List, ast.Tuple)):
        names = [_ctypes_name(e, env) for e in node.elts]
        return None if any(n is None for n in names) else names  # type: ignore[misc]
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            a, b = _fold(node.left, env), _fold(node.right, env)
            return None if a is None or b is None else a + b
        if isinstance(node.op, ast.Mult):
            for seq, k in ((node.left, node.right), (node.right, node.left)):
                k = _resolve(k, env)
                if isinstance(k, ast.Constant) and isinstance(k.value, int) \
                        and not isinstance(k.value, bool):
                    got = _fold(seq, env)
                    return None if got is None else got * k.value
    return None


def _library(node: Optional[ast.expr], env: Dict[str, ast.expr]
             ) -> Optional[ast.Call]:
    """The build call whose loaded library ``node`` is: ``X.lib`` where
    ``X`` is (an alias of) the call."""
    node = _resolve(node, env)
    if isinstance(node, ast.Attribute) and node.attr == "lib":
        base = _resolve(node.value, env)
        return base if _is_build(base) else None    # type: ignore[return-value]
    return None


def _function(node: ast.expr, env: Dict[str, ast.expr]
              ) -> Optional[Tuple[ast.Call, str]]:
    """(build call, C function name) that ``node`` denotes:
    ``lib.<fn>`` or an alias of it."""
    node = _resolve(node, env)
    if isinstance(node, ast.Attribute):
        call = _library(node.value, env)
        if call is not None:
            return call, node.attr
    return None


def _scopes(sf: SourceFile) -> List[Tuple[ast.AST, Dict[str, ast.expr]]]:
    """Each function with its environment (module assignments, then its
    own), and the module itself."""
    module_env = sf.assign_env()
    out: List[Tuple[ast.AST, Dict[str, ast.expr]]] = []
    for fn in ast.walk(sf.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            env = dict(module_env)
            env.update(sf.assign_env(fn))
            out.append((fn, env))
    out.append((sf.tree, module_env))
    return out


def _source_display(index: ProjectIndex, path: Path,
                    repo_root: Optional[Path]) -> str:
    resolved = path.resolve()
    for tf in index.texts.values():
        if tf.path.resolve() == resolved:
            return tf.display
    if repo_root is not None:
        try:
            return resolved.relative_to(repo_root).as_posix()
        except ValueError:
            pass
    return str(path)


def _binding_findings(sf: SourceFile, index: ProjectIndex,
                      repo_root: Optional[Path],
                      rounding_done: Set[str]) -> List[Finding]:
    path, here = sf.display, sf.path.resolve()
    out: List[Finding] = []
    builds: Dict[int, _Build] = {}
    done: Set[int] = set()
    for scope, env in _scopes(sf):
        for node in ast.walk(scope):
            if _is_build(node) and id(node) not in builds:
                src = _resolve(node.args[1], env)
                elts = src.elts if isinstance(src, (ast.List, ast.Tuple)) \
                    else [src]
                sources = [_path(e, env, here) for e in elts]
                if any(s is None for s in sources):
                    out.append(Finding(
                        "ctypes-arity", path, node.lineno,
                        "cannot resolve the library's sources to files — "
                        "its bindings cannot be checked"))
                    sources = []
                flags_expr = node.args[2]
                builds[id(node)] = _Build(
                    node, [s for s in sources if s is not None],
                    _strings(flags_expr, env))
    # the C side of every build, and its flag rules
    cfuncs: Dict[int, Dict[str, CFunc]] = {}
    for key, b in builds.items():
        funcs: Dict[str, CFunc] = {}
        rounded = False
        for src in b.sources:
            display = _source_display(index, src, repo_root)
            tf = index.load_text(src, display)
            if tf is None:
                continue
            funcs.update(extern_c_functions(tf.text))
            rounded |= uses_rounded_intrinsics(tf.text)
            if b.flags is not None and b.flags & FMAD_OFF and \
                    display not in rounding_done:
                rounding_done.add(display)
                out.extend(rounding_findings(display, tf.text))
        cfuncs[key] = funcs
        fmad_off = bool(b.flags and b.flags & FMAD_OFF)
        if rounded and not fmad_off:
            out.append(Finding(
                "cuda-fmad-flag", path, b.call.lineno,
                "the library's source rounds with __d*_rn / __f*_rn (bit-"
                "exact) but it is built without --fmad=false"))
        elif fmad_off and not rounded:
            out.append(Finding(
                "cuda-fmad-flag", path, b.call.lineno,
                "--fmad=false on a library whose source is not written to "
                "the bit-exact contract (no __d*_rn / __f*_rn) — it only "
                "slows its float kernels"))
    # the bindings
    for scope, env in _scopes(sf):
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and tgt.attr in ("argtypes", "restype")) \
                    or id(node) in done:
                continue
            done.add(id(node))
            fn = _function(tgt.value, env)
            if fn is None:
                out.append(Finding(
                    "ctypes-arity", path, node.lineno,
                    f"{tgt.attr} set on an expression the pass cannot "
                    f"resolve to a built library's function"))
                continue
            call, name = fn
            c = cfuncs.get(id(call), {}).get(name)
            if c is None:
                if builds[id(call)].sources:
                    out.append(Finding(
                        "ctypes-arity", path, node.lineno,
                        f"no extern \"C\" function {name} in the library's "
                        f"sources"))
                continue
            if tgt.attr == "restype":
                got = _ctypes_name(node.value, env)
                want = C_KINDS.get(c.ret)
                ok = (got == "None") if c.ret == "void" else \
                    (want is not None and got in want)
                if not ok:
                    out.append(Finding(
                        "ctypes-type", path, node.lineno,
                        f"{name}.restype is {got}, the C function returns "
                        f"{c.ret}"))
                continue
            names = _fold(node.value, env)
            if names is None:
                out.append(Finding(
                    "ctypes-arity", path, node.lineno,
                    f"{name}.argtypes does not fold to a constant list — "
                    f"its arity cannot be checked"))
                continue
            if len(names) != len(c.params):
                out.append(Finding(
                    "ctypes-arity", path, node.lineno,
                    f"{name}.argtypes has {len(names)} entries, the C "
                    f"function takes {len(c.params)} parameters"))
                continue
            for k, (got, kind) in enumerate(zip(names, c.params)):
                want = C_KINDS.get(kind)
                if want is None or got not in want:
                    out.append(Finding(
                        "ctypes-type", path, node.lineno,
                        f"{name}.argtypes[{k}] is {got}, parameter {k} is "
                        f"{kind}"))
    # a function whose restype is never set returns c_int to ctypes
    set_rest = {(id(c), n) for c, n in _restype_sets(sf)}
    for key, funcs in cfuncs.items():
        call = builds[key].call
        for name in _bound_functions(sf, call):
            c = funcs.get(name)
            if c is not None and (key, name) not in set_rest and \
                    c.ret not in ("int",):
                out.append(Finding(
                    "ctypes-type", path, call.lineno,
                    f"{name} returns {c.ret} but its restype is never set "
                    f"(ctypes reads a c_int)"))
    return out


def _restype_sets(sf: SourceFile) -> List[Tuple[ast.Call, str]]:
    got = []
    for scope, env in _scopes(sf):
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr == "restype":
                fn = _function(node.targets[0].value, env)
                if fn is not None:
                    got.append(fn)
    return got


def _bound_functions(sf: SourceFile, call: ast.Call) -> Set[str]:
    """Names of the build's functions whose ``argtypes`` are set."""
    names = set()
    for scope, env in _scopes(sf):
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr == "argtypes":
                fn = _function(node.targets[0].value, env)
                if fn is not None and fn[0] is call:
                    names.add(fn[1])
    return names


def _rtol_findings(sf: SourceFile) -> List[Finding]:
    """``F32_NEAR_TIE_RTOL``: definition site only."""
    return [Finding(
        "kernel-rtol-site", sf.display, node.lineno,
        f"{RTOL_NAME} consumed in source — it documents the near-tie band "
        f"for tests; decisions must not branch on it")
        for node in ast.walk(sf.tree)
        if isinstance(node, ast.Name) and node.id == RTOL_NAME
        and isinstance(node.ctx, ast.Load)]


def run(index: ProjectIndex, repo_root: Optional[Path] = None
        ) -> List[Finding]:
    """The kernel rules over every indexed Python file (the CUDA sources
    they build from are read into the index as text)."""
    out: List[Finding] = []
    rounding_done: Set[str] = set()
    for sf in list(index.files.values()):
        out.extend(_rtol_findings(sf))
        out.extend(_binding_findings(sf, index, repo_root, rounding_done))
    return out

"""``python -m repro_torch.analysis`` — the port's static invariant
analyzer, the twin of ``python -m repro.analysis``.

Two modes:

  * **repo mode** (no paths): scan ``src/repro_torch`` (its ``*.py``,
    and the ``*.cu`` sources under it; not ``analysis/`` itself) with
    each rule confined to its repo scope (decision-layer float lint to
    ``core/engine.py``/``core/api.py``, host-sync and the protocol gate
    to ``core/backends/``, concurrency rules to ``service/``, kernel
    rules to the package) and apply the port's committed ratchet
    baseline ``src/repro_torch/analysis/baseline.txt``.  ``--paths``
    narrows the scan to matching path prefixes without changing rule
    scoping.
  * **explicit mode** (paths given): apply *every* rule to exactly those
    files (directories expand to their ``*.py`` and ``*.cu`` trees; the
    file list is sorted and deduplicated) with no default baseline —
    this is what the fixture tests use to demonstrate each rule.

All passes share one :class:`~.index.ProjectIndex`, so each file is read
and parsed exactly once no matter how many passes consume it.

Exit codes: 0 clean, 1 findings (or stale baseline entries — the
ratchet only tightens), 2 broken invocation (missing file, syntax
error, unknown rule).  Findings print as ``path:line: [rule] msg``, or
with ``--format=json`` as one JSON object per line carrying ``rule``,
``path``, ``line``, ``source`` (the stripped source line), the
suppression ``fingerprint``, and ``message``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import concurrency, kernels, lint, typing_gate
from .findings import (Finding, apply_baseline, apply_pragmas, fingerprint,
                       load_baseline)
from .index import ProjectIndex

#: every rule the analyzer knows, with its repo-mode path scope
ALL_RULES = {**lint.RULES, **kernels.RULES, **typing_gate.RULES,
             **concurrency.RULES}

_REPO_ROOT = Path(__file__).resolve().parents[3]
_SRC_ROOT = Path(__file__).resolve().parents[1]        # src/repro_torch
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.txt"
SUFFIXES = (".py", ".cu")


def _tree(root: Path) -> List[Path]:
    return sorted(p for suffix in SUFFIXES for p in root.rglob("*" + suffix))


def _repo_files() -> List[Tuple[Path, str]]:
    out = []
    for p in _tree(_SRC_ROOT):
        rel = p.relative_to(_REPO_ROOT).as_posix()
        if rel.startswith("src/repro_torch/analysis/"):
            continue                  # the analyzer does not police itself
        out.append((p, rel))
    return out


def _explicit_files(raw_paths: Sequence[str]
                    ) -> Tuple[List[Tuple[Path, str]], Optional[str]]:
    """Expand/sort/dedupe positional paths.  Directories contribute
    their ``*.py`` and ``*.cu`` trees; overlapping arguments (``pkg
    pkg/mod.py``, a file named twice) analyze once.  Returns (files,
    error)."""
    collected: List[Tuple[Path, str]] = []
    for raw in raw_paths:
        p = Path(raw)
        if p.is_dir():
            for sub in _tree(p):
                collected.append((sub, sub.as_posix()))
        elif p.is_file():
            collected.append((p, raw))
        else:
            return [], f"no such file or directory: {raw}"
    seen: Set[Path] = set()
    files: List[Tuple[Path, str]] = []
    for p, display in sorted(collected, key=lambda t: t[1]):
        resolved = p.resolve()
        if resolved in seen:
            continue
        seen.add(resolved)
        files.append((p, display))
    return files, None


def _collect(files: Sequence[Tuple[Path, str]], repo_mode: bool,
             rules: Optional[set],
             ) -> Tuple[List[Finding], Dict[str, List[str]], List[str]]:
    index = ProjectIndex()
    findings: List[Finding] = []
    for path, display in files:
        if path.suffix != ".py":
            index.load_text(path, display)
            continue
        sf = index.load(path, display)
        if sf is None:
            continue
        findings.extend(lint.run(sf))
        findings.extend(concurrency.run(sf))
    findings.extend(typing_gate.run(index))
    findings.extend(kernels.run(index, _REPO_ROOT))
    lines_of = {f.display: f.lines for f in list(index.files.values())
                + list(index.texts.values())}

    if repo_mode:
        findings = [f for f in findings
                    if f.rule not in ALL_RULES or ALL_RULES[f.rule](f.path)]
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    findings = apply_pragmas(findings, lines_of)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, lines_of, index.errors


def _finding_json(f: Finding, fp: str, lines: List[str]) -> str:
    source = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
    return json.dumps({"rule": f.rule, "path": f.path, "line": f.line,
                       "source": source, "fingerprint": fp,
                       "message": f.message})


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant analyzer of the port (ctypes "
                    "bindings and CUDA rounding, bit-exactness lint, "
                    "backend protocol gate, service concurrency races)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze with ALL rules; "
                         "omit to scan the repo with per-rule scopes + "
                         "baseline")
    ap.add_argument("--baseline", metavar="FILE",
                    help=f"ratchet file (repo mode default: "
                         f"{DEFAULT_BASELINE} at the repo root, if present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--rules", metavar="ID[,ID...]",
                    help="restrict to a comma-separated subset of rules")
    ap.add_argument("--paths", dest="path_filter", metavar="PREFIX[,...]",
                    help="repo mode only: restrict the scan to files whose "
                         "repo-relative path starts with one of these "
                         "prefixes (baseline entries outside them are "
                         "ignored, not stale)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format: human text (default) or one JSON "
                         "finding object per line")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(ALL_RULES):
            print(rule)
        return 0

    rules: Optional[set] = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(ALL_RULES)
        if unknown:
            print(f"error: unknown rule(s): {', '.join(sorted(unknown))} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2

    repo_mode = not args.paths
    prefixes: Optional[List[str]] = None
    if args.path_filter:
        if not repo_mode:
            print("error: --paths filters repo-mode scans; with explicit "
                  "paths just list what you want analyzed", file=sys.stderr)
            return 2
        prefixes = [p.strip() for p in args.path_filter.split(",")
                    if p.strip()]

    if repo_mode:
        files = _repo_files()
        if prefixes is not None:
            files = [(p, rel) for p, rel in files
                     if any(rel.startswith(pre) for pre in prefixes)]
            if not files:
                print(f"error: --paths {args.path_filter!r} matches no "
                      f"repo files", file=sys.stderr)
                return 2
    else:
        files, err = _explicit_files(args.paths)
        if err is not None:
            print(f"error: {err}", file=sys.stderr)
            return 2

    findings, lines_of, errors = _collect(files, repo_mode, rules)
    if errors:
        for err in errors:
            print(f"error: {err}", file=sys.stderr)
        return 2

    fp_of = {f: fingerprint(f, f.path, lines_of.get(f.path, []))
             for f in findings}

    baseline_path: Optional[Path] = None
    if args.baseline:
        baseline_path = Path(args.baseline)
    elif repo_mode:
        cand = _REPO_ROOT / DEFAULT_BASELINE
        if cand.is_file() or args.write_baseline:
            baseline_path = cand

    if args.write_baseline:
        if baseline_path is None:
            print("error: --write-baseline needs --baseline FILE in "
                  "explicit-path mode", file=sys.stderr)
            return 2
        entries = sorted(set(fp_of.values()))
        header = ("# Ratchet baseline for `python -m repro_torch.analysis`.\n"
                  "# One fingerprint (path::rule::source-line) per entry —\n"
                  "# each is a pre-existing finding tolerated until fixed;\n"
                  "# stale entries FAIL the run so this file only shrinks.\n")
        baseline_path.write_text(
            header + "".join(e + "\n" for e in entries), encoding="utf-8")
        print(f"wrote {len(entries)} baseline entr"
              f"{'y' if len(entries) == 1 else 'ies'} to {baseline_path}")
        return 0

    baselined: List[Finding] = []
    stale: List[str] = []
    if baseline_path is not None and baseline_path.is_file():
        entries = load_baseline(str(baseline_path))
        if prefixes is not None:
            # entries for unscanned paths are out of sight: neither
            # applied nor reported stale under a narrowed scan
            entries = [e for e in entries
                       if any(e.split("::", 1)[0].startswith(pre)
                              for pre in prefixes)]
        findings, baselined, stale = apply_baseline(findings, entries, fp_of)
    elif args.baseline:
        print(f"error: baseline file {args.baseline!r} does not exist",
              file=sys.stderr)
        return 2

    if args.format == "json":
        for f in findings:
            print(_finding_json(f, fp_of[f], lines_of.get(f.path, [])))
        for entry in stale:
            print(json.dumps({"rule": "stale-baseline-entry", "path":
                              entry.split("::", 1)[0], "line": 0,
                              "source": "", "fingerprint": entry,
                              "message": "stale baseline entry (fix is "
                                         "in — delete the line)"}))
        return 1 if (findings or stale) else 0

    for f in findings:
        print(f.format())
    for entry in stale:
        print(f"stale baseline entry (fix is in — delete the line): {entry}")

    n_files = len(files)
    if findings or stale:
        print(f"analysis: {len(findings)} finding(s), {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'} across "
              f"{n_files} file(s)")
        return 1
    suffix = f" ({len(baselined)} baselined)" if baselined else ""
    print(f"analysis: clean — {n_files} file(s){suffix}")
    return 0

"""Finding records, inline suppression pragmas, and the ratchet baseline.

Twin of ``repro.analysis.findings``; a pragma in a CUDA source is a
``//`` comment.

A :class:`Finding` is one analyzer hit: ``(rule, path, line, message)``.
Two suppression mechanisms exist, mirroring the two legitimate reasons a
finding may stay in the tree:

  * **pragma** — ``# analysis: allow[rule-id] <one-line justification>``
    (``// analysis: ...`` in a ``.cu`` source) on the finding's line (or
    the line directly above it) marks a site that is *correct by design*
    (e.g. the device backend's documented one fetch per dispatch).  The justification
    text is mandatory: an allow without a reason is itself a finding.
  * **baseline** — a committed ratchet file (one fingerprint per line)
    holding *pre-existing* findings that are tolerated but must be
    burned down.  A finding whose fingerprint is in the baseline passes;
    a baseline entry that no longer matches any finding FAILS the run
    ("stale entry") so the file shrinks in the same change that fixes
    the code — the ratchet only ever tightens.

Fingerprints are ``relpath::rule::<stripped source line>`` — line-number
free, so unrelated edits above a baselined site do not churn the file.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Sequence, Tuple

PRAGMA_RE = re.compile(
    r"(?:#|//)\s*analysis:\s*allow\[(?P<rule>[a-z0-9-]+)\]\s*"
    r"(?P<reason>.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit at ``path:line`` produced by ``rule``."""

    rule: str
    path: str        # as given to the pass (absolute or repo-relative)
    line: int        # 1-indexed
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def pragma_on(lines: Sequence[str], line: int) -> Dict[str, str]:
    """Allow-pragmas covering source line ``line`` (1-indexed):
    ``{rule-id: justification}`` from the line itself and the line
    directly above it."""
    out: Dict[str, str] = {}
    for ln in (line - 1, line):              # line above, then the line
        if 1 <= ln <= len(lines):
            m = PRAGMA_RE.search(lines[ln - 1])
            if m:
                out[m.group("rule")] = m.group("reason").strip()
    return out


def apply_pragmas(findings: Iterable[Finding],
                  lines_of: Dict[str, Sequence[str]]) -> List[Finding]:
    """Drop findings suppressed by a justified allow-pragma; turn
    *unjustified* pragma suppressions into their own finding."""
    kept: List[Finding] = []
    for f in findings:
        lines = lines_of.get(f.path)
        pragmas = pragma_on(lines, f.line) if lines is not None else {}
        if f.rule in pragmas:
            if not pragmas[f.rule]:
                kept.append(Finding(
                    "allow-without-reason", f.path, f.line,
                    f"allow[{f.rule}] pragma carries no justification "
                    f"(suppressed: {f.message})"))
            continue
        kept.append(f)
    return kept


def fingerprint(f: Finding, relpath: str,
                lines: Sequence[str]) -> str:
    snippet = lines[f.line - 1].strip() if 1 <= f.line <= len(lines) else ""
    return f"{relpath}::{f.rule}::{snippet}"


def load_baseline(path: str) -> List[str]:
    """Baseline fingerprints, one per line; ``#`` comments and blank
    lines are ignored (justifications live in the comments)."""
    entries: List[str] = []
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if line and not line.startswith("#"):
                entries.append(line)
    return entries


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[str],
                   fp_of: Dict[Finding, str]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split ``findings`` against the baseline.

    Returns ``(new, baselined, stale)``: findings not covered by the
    baseline, findings it tolerates, and baseline entries matching
    nothing (each stale entry must be deleted — the ratchet tightens).
    Duplicate fingerprints (several findings on one line) share one
    entry.
    """
    remaining = set(entries)
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        fp = fp_of[f]
        if fp in entries:
            baselined.append(f)
            remaining.discard(fp)
        else:
            new.append(f)
    return new, baselined, sorted(remaining)

# The port's copy of repro/analysis/common.py: only the package prefix
# of its imports differs.
"""Shared plumbing for the repro.analysis checkers.

Findings, the annotation-comment scanner, and the suppression baseline.
Everything here is stdlib-only (ast/tokenize/re) by design — the lint
must run in any environment the repo runs in, with no extra installs.

Annotation syntax (scanned from comments, since ast drops them):

  # guarded-by: self._lock      on a field assignment: every read/write
                                of that field outside `with self._lock:`
                                is a finding. On a `def` line: the method
                                is documented as called WITH the lock
                                held, so the guard is assumed inside.
  # analysis: callback          the field holds user/backend code: calling
                                it while ANY guard is held is a finding
                                (the classic self-deadlock). Combine:
                                # guarded-by: self._lock (analysis: callback)

Baseline format (lint-baseline.txt): one fingerprint per line,

  rule::path::qualname::subject  # one-line justification

The justification comment is MANDATORY — an exception nobody can explain
should not be on the books. Fingerprints carry no line numbers, so
unrelated edits don't churn the file; entries that no longer match any
finding are STALE and fail the lint (delete them).
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Set, Tuple

GUARD_RE = re.compile(r"guarded-by:\s*self\.(\w+)")
CALLBACK_RE = re.compile(r"analysis:\s*callback")


@dataclass(frozen=True)
class Finding:
    rule: str                  # e.g. guarded-field, callback-under-lock
    path: str                  # repo-relative, forward slashes
    line: int                  # 1-indexed (NOT part of the fingerprint)
    qualname: str              # Class.method enclosing the finding
    subject: str               # the field/kind/module the rule fired on
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.qualname}::{self.subject}"

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.qualname}: "
                f"{self.message}")


def scan_comments(source: str) -> Tuple[Dict[int, str], Set[int]]:
    """Extract the annotation comments ast cannot see. Returns
    ({lineno: guard_field}, {linenos with a callback marker})."""
    guards: Dict[int, str] = {}
    callbacks: Set[int] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = GUARD_RE.search(tok.string)
            if m:
                guards[tok.start[0]] = m.group(1)
            if CALLBACK_RE.search(tok.string):
                callbacks.add(tok.start[0])
    except tokenize.TokenError:
        pass                   # a syntax error will surface in ast.parse
    return guards, callbacks


class QualnameVisitor:
    """Mixin-style helper: checkers walk with an explicit stack so every
    Finding can say which Class.method it sits in."""

    def __init__(self) -> None:
        self.stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"


# ---------------------------------------------------------------------------
# suppression baseline
# ---------------------------------------------------------------------------

class BaselineError(ValueError):
    """The baseline file itself is malformed (e.g. missing justification)."""


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> justification. Raises BaselineError on an entry with
    no ` # why` justification."""
    entries: Dict[str, str] = {}
    problems: List[str] = []
    with open(path, encoding="utf-8") as fh:
        for n, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            fp, sep, why = line.partition("  # ")
            if not sep or not why.strip():
                problems.append(f"{path}:{n}: baseline entry has no "
                                f"justification (append `  # why`): {line}")
                continue
            entries[fp.strip()] = why.strip()
    if problems:
        raise BaselineError("\n".join(problems))
    return entries


def apply_baseline(findings: Iterable[Finding], baseline: Dict[str, str]
                   ) -> Tuple[List[Finding], List[str]]:
    """Split findings into (unsuppressed, stale-baseline-fingerprints).
    A stale entry — in the file but matching nothing — is itself an error:
    either the defect was fixed (delete the line) or the fingerprint
    drifted (re-justify it)."""
    used: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.fingerprint in baseline:
            used.add(f.fingerprint)
        else:
            out.append(f)
    stale = sorted(set(baseline) - used)
    return out, stale


__all__ = ["Finding", "QualnameVisitor", "BaselineError", "GUARD_RE",
           "CALLBACK_RE", "scan_comments", "load_baseline",
           "apply_baseline"]

# The port's copy of repro/analysis/runner.py. Besides the package prefix
# of its imports, DEFAULT_PATHS is the port's package and the command and
# status line name repro_torch.analysis.
"""The lint runner behind `python -m repro_torch.analysis [paths...]
[--baseline FILE]`.

Runs all three checkers (locks, events, api) over every .py file under
the given paths (default: src/repro_torch — tests are excluded on
purpose: test fixtures contain deliberate violations), then subtracts the
suppression baseline. Exit 0 only when every remaining finding count is
zero AND the baseline has no stale or unjustified entries. Run from the
repository's root with `--baseline src/repro_torch/analysis/baseline.txt`:
fingerprints hold paths relative to the working directory.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import List, Optional

from . import api, events, locks
from .common import BaselineError, Finding, apply_baseline, load_baseline

DEFAULT_PATHS = ("src/repro_torch",)
CHECKERS = (locks.check_module, events.check_module, api.check_module)


def iter_py_files(paths) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def check_file(path: str, rel: str) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", rel, e.lineno or 0, "<module>",
                        "parse", f"cannot parse: {e.msg}")]
    out: List[Finding] = []
    for checker in CHECKERS:
        out.extend(checker(tree, source, rel))
    return out


def run(paths=None, baseline: Optional[str] = None,
        out=sys.stdout) -> int:
    paths = list(paths) if paths else [p for p in DEFAULT_PATHS
                                       if os.path.exists(p)]
    files = iter_py_files(paths)
    findings: List[Finding] = []
    for path in files:
        rel = os.path.relpath(path).replace(os.sep, "/")
        findings.extend(check_file(path, rel))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    suppressed = 0
    stale: List[str] = []
    if baseline is not None and os.path.exists(baseline):
        try:
            entries = load_baseline(baseline)
        except BaselineError as e:
            print(e, file=out)
            print("FAIL: malformed baseline", file=out)
            return 1
        total = len(findings)
        findings, stale = apply_baseline(findings, entries)
        suppressed = total - len(findings)

    for f in findings:
        print(f, file=out)
    for fp in stale:
        print(f"{baseline}: STALE baseline entry (matches nothing — "
              f"fixed? delete the line): {fp}", file=out)
    status = "FAIL" if findings or stale else "OK"
    print(f"repro_torch.analysis: {status} — {len(files)} files, "
          f"{len(findings)} finding(s), {suppressed} suppressed by "
          f"baseline, {len(stale)} stale baseline entr(y/ies)", file=out)
    return 1 if findings or stale else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency + event-protocol + API-misuse lints")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to check (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline file (lint-baseline.txt)")
    args = ap.parse_args(argv)
    return run(args.paths or None, baseline=args.baseline)

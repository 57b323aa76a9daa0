# The port's copy of repro/analysis/events.py: only the package prefix
# of its imports differs.
"""Static pass over EventLog.emit call sites.

The runtime half of the protocol lives in repro.exec.protocol
(validate_trace replays recorded streams); this is the source-side half:
every `*.emit(...)` call site must

  event-kind     pass a DECLARED kind constant (SUBMIT, COMPLETE, ...)
                 as the first argument — by name, not a string literal
                 (literals drift; a typo'd "compelte" event would record
                 garbage no replay could interpret) and not a runtime
                 variable (unverifiable statically; the two deliberate
                 replay/fan-out sites are baselined with justification)
  event-fields   pass the kind's REQUIRED_FIELDS as keyword arguments:
                 COMPLETE carries ok=, RETRY/LOST carry attempt= — the
                 fields validate_trace needs to drive its state machine

Matches any receiver spelled `<expr>.emit(...)`: events.emit,
self.events.emit, log.emit. The repo has no other emit() API; if one
appears, name its first parameter something other than a kind and give
it a different verb.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.exec.protocol import KIND_BY_NAME, REQUIRED_FIELDS

from .common import Finding

_REQUIRED_BY_NAME = {name: REQUIRED_FIELDS[value]
                     for name, value in KIND_BY_NAME.items()
                     if value in REQUIRED_FIELDS}


def _kind_name(arg: ast.AST) -> Optional[str]:
    """The declared-constant name the first emit arg resolves to, if any
    (SUBMIT as a bare Name or as base.SUBMIT-style Attribute)."""
    if isinstance(arg, ast.Name) and arg.id in KIND_BY_NAME:
        return arg.id
    if isinstance(arg, ast.Attribute) and arg.attr in KIND_BY_NAME:
        return arg.attr
    return None


class _EmitChecker(ast.NodeVisitor):
    def __init__(self, path: str, findings: List[Finding]):
        self.path = path
        self.findings = findings
        self.stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def _scoped(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_ClassDef = _scoped
    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "emit" and node.args:
            self._check_emit(node)
        self.generic_visit(node)

    def _check_emit(self, node: ast.Call) -> None:
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.findings.append(Finding(
                "event-kind", self.path, node.lineno, self.qualname,
                repr(arg.value),
                f"emit with string-literal kind {arg.value!r}; use the "
                f"declared constant from repro.exec.base"))
            return
        name = _kind_name(arg)
        if name is None:
            subject = ast.unparse(arg)
            self.findings.append(Finding(
                "event-kind", self.path, node.lineno, self.qualname,
                subject,
                f"emit kind {subject!r} is not a declared protocol "
                f"constant (dynamic kinds are statically unverifiable)"))
            return
        required = _REQUIRED_BY_NAME.get(name, ())
        if required:
            kws = {kw.arg for kw in node.keywords}
            missing = [r for r in required if r not in kws]
            if missing:
                self.findings.append(Finding(
                    "event-fields", self.path, node.lineno, self.qualname,
                    name,
                    f"{name} emit is missing required field(s) "
                    f"{missing}: validate_trace cannot replay it"))


def check_module(tree: ast.Module, source: str, path: str
                 ) -> List[Finding]:
    findings: List[Finding] = []
    _EmitChecker(path, findings).visit(tree)
    return findings


def check_source(source: str, path: str = "<fixture>") -> List[Finding]:
    return check_module(ast.parse(source), source, path)


__all__ = ["check_module", "check_source"]

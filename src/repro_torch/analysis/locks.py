# The port's copy of repro/analysis/locks.py: only the package prefix
# of its imports differs.
"""AST lock-discipline checker for annotated classes.

Scope: intentionally narrow and precise. A class opts in by annotating
fields in its __init__ with `# guarded-by: self._lock` (see
analysis.common for the syntax); unannotated classes are skipped
entirely, so the checker produces findings only where someone declared
the discipline to check. Per annotated class it enforces, method by
method (intraprocedurally):

  guarded-field        a read or write of a guarded field while the
                       declared guard is not held (held = lexically
                       inside `with self._lock:`; a `# guarded-by:` on a
                       def line declares the whole method runs with the
                       guard held — the documented caller contract)
  callback-under-lock  a call THROUGH a field marked `analysis: callback`
                       while any guard is held: user/backend code under a
                       private lock is the classic self-deadlock (and,
                       with a guarded callback field, calling
                       self.on_x(...) lock-free is a guarded-field read —
                       together the two rules force the snapshot idiom:
                       grab the handler under the lock, invoke it outside)
  blocking-under-lock  a known-blocking call while a guard is held:
                       sleep/wait/join/acquire/readline/recv/select,
                       queue-style .get(), and this repo's own blocking
                       helpers (await_ready, teardown). Calls on the held
                       guard itself (self._cond.wait()) are exempt —
                       that's how condition variables work.

Nested functions and lambdas are analyzed with an EMPTY held set: they
usually escape to timers/threads and run later, when the lock is long
released. __init__ is skipped — the object is not yet shared there.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .common import Finding, scan_comments

#: method names that block (directly or by convention) — flagged when
#: called with a lock held, unless called on the held guard itself
BLOCKING_METHODS = {"sleep", "wait", "join", "acquire", "readline",
                    "read", "recv", "select"}
#: bare-name calls that block (this repo's helpers + time.sleep idiom)
BLOCKING_NAMES = {"sleep", "await_ready", "teardown"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when `node` is exactly `self.X`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _line_guard(guards: Dict[int, str], lo: int, hi: int) -> Optional[str]:
    for ln in range(lo, hi + 1):
        if ln in guards:
            return guards[ln]
    return None


class _ClassInfo:
    def __init__(self) -> None:
        self.guarded: Dict[str, str] = {}    # field -> guard field
        self.callbacks: Set[str] = set()     # fields holding foreign code
        self.method_guards: Dict[str, str] = {}   # method -> held guard


def _collect(cls: ast.ClassDef, guards: Dict[int, str],
             callbacks: Set[int]) -> _ClassInfo:
    """Read the class's declared discipline off its annotation comments."""
    info = _ClassInfo()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            lo, hi = node.lineno, node.end_lineno or node.lineno
            g = _line_guard(guards, lo, hi)
            marked_cb = any(ln in callbacks for ln in range(lo, hi + 1))
            for t in targets:
                field = _self_attr(t)
                if field is None:
                    continue
                if g is not None:
                    info.guarded[field] = g
                if marked_cb:
                    info.callbacks.add(field)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a guard comment on (or right above) the def line declares
            # "callers hold this lock"
            g = guards.get(node.lineno) or guards.get(node.lineno - 1)
            if g is not None:
                info.method_guards[node.name] = g
    return info


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, info: _ClassInfo, path: str, qualname: str,
                 held: Set[str], findings: List[Finding]):
        self.info = info
        self.path = path
        self.qualname = qualname
        self.held = held
        self.findings = findings

    def _finding(self, rule: str, node: ast.AST, subject: str,
                 message: str) -> None:
        self.findings.append(Finding(rule, self.path, node.lineno,
                                     self.qualname, subject, message))

    # ---- lock scopes ---------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr not in self.held:
                entered.append(attr)
        self.held.update(entered)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(entered)

    # ---- escaping code runs later, without the lock --------------------
    def _visit_nested(self, node: ast.AST) -> None:
        sub = _MethodChecker(self.info, self.path, self.qualname,
                             set(), self.findings)
        for child in ast.iter_child_nodes(node):
            sub.visit(child)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested(node)

    # ---- the rules -----------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        attr = _self_attr(func)
        if attr is not None and attr in self.info.callbacks:
            if self.held:
                self._finding(
                    "callback-under-lock", node, attr,
                    f"self.{attr}(...) invoked while holding "
                    f"{sorted(self.held)}: foreign code under a private "
                    f"lock can re-enter and self-deadlock — snapshot the "
                    f"handler under the lock, call it after release")
                # deliberate: don't ALSO report the guarded-field read
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        if self.held:
            self._check_blocking(node)
        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id in BLOCKING_NAMES:
            self._finding("blocking-under-lock", node, func.id,
                          f"{func.id}(...) called while holding "
                          f"{sorted(self.held)}")
            return
        if not isinstance(func, ast.Attribute):
            return
        # calls on the held guard itself are the POINT of a condvar
        recv = _self_attr(func.value)
        if recv is not None and recv in self.held:
            return
        name = func.attr
        if name in BLOCKING_METHODS:
            self._finding("blocking-under-lock", node, name,
                          f".{name}(...) called while holding "
                          f"{sorted(self.held)}")
        elif name == "get":
            # Queue.get() blocks; dict.get(k, default) does not — only
            # flag the no-positional-args / block=/timeout= shapes
            kws = {kw.arg for kw in node.keywords}
            if not node.args or kws & {"block", "timeout"}:
                self._finding("blocking-under-lock", node, name,
                              f".get() (queue-style, may block) called "
                              f"while holding {sorted(self.held)}")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr in self.info.guarded:
            guard = self.info.guarded[attr]
            if guard not in self.held:
                self._finding(
                    "guarded-field", node, attr,
                    f"self.{attr} is `guarded-by: self.{guard}` but the "
                    f"guard is not held here")
        self.generic_visit(node)


def check_module(tree: ast.Module, source: str, path: str
                 ) -> List[Finding]:
    guards, callbacks = scan_comments(source)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = _collect(node, guards, callbacks)
        if not info.guarded and not info.callbacks \
                and not info.method_guards:
            continue                     # class never opted in
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if item.name == "__init__":
                continue                 # not yet shared across threads
            held: Set[str] = set()
            g = info.method_guards.get(item.name)
            if g is not None:
                held.add(g)
            checker = _MethodChecker(info, path,
                                     f"{node.name}.{item.name}", held,
                                     findings)
            for stmt in item.body:
                checker.visit(stmt)
    return findings


def check_source(source: str, path: str = "<fixture>") -> List[Finding]:
    return check_module(ast.parse(source), source, path)


__all__ = ["check_module", "check_source", "BLOCKING_METHODS",
           "BLOCKING_NAMES"]

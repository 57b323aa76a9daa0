# The port's copy of repro/analysis/api.py. Besides the package prefix of
# its imports, DEPRECATED_MODULES names the port's shims, repro_torch.*.
"""API-misuse lints: deprecated shims and leak-prone subprocess spawns.

  deprecated-import   the consolidation reduced
                      repro_torch.core.realproc and
                      repro_torch.taskarray.runner_* to deprecation
                      shims over repro_torch.exec; importing
                      them in NEW code re-grows exactly the drift the
                      consolidation removed. The shim modules themselves
                      (and repro_torch.taskarray's lazy __init__
                      re-exports,
                      which go through importlib, not import statements)
                      are exempt by path.

  popen-teardown      every real-process spawn (subprocess.Popen or this
                      repo's _spawn_worker/_spawn_launcher helpers) must
                      be reachable by a teardown path: lexically inside a
                      `try` with a `finally` block, or a `try` whose
                      exception handler calls teardown(...). A spawn in a
                      bare `return` is exempt — that is a factory, and
                      teardown responsibility transfers to the caller
                      along with the handle. The abandoned-children bug
                      this encodes was real: an assert between
                      spawn and cleanup leaked live workers.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from .common import Finding

DEPRECATED_MODULES = {
    "repro_torch.core.realproc": "repro_torch.exec.pool (launch_once) / "
                                 "get_backend('procpool')",
    "repro_torch.taskarray.runner_real":
        "repro_torch.exec.get_backend('procpool')",
    "repro_torch.taskarray.runner_sim": "repro_torch.exec.get_backend('sim')",
    "repro_torch.taskarray.runner_inline":
        "repro_torch.exec.get_backend('inline')",
}
#: the shims themselves (path suffixes, forward slashes)
_SHIM_PATHS = ("core/realproc.py", "taskarray/runner_real.py",
               "taskarray/runner_sim.py", "taskarray/runner_inline.py")

SPAWN_CALLS = {"Popen", "_spawn_worker", "_spawn_launcher"}


def _call_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _deprecated(module: str) -> Optional[Tuple[str, str]]:
    for dep, repl in DEPRECATED_MODULES.items():
        if module == dep or module.startswith(dep + "."):
            return dep, repl
    return None


def _handler_tears_down(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Call) \
                and _call_name(node.func) == "teardown":
            return True
    return False


class _ApiChecker(ast.NodeVisitor):
    def __init__(self, path: str, findings: List[Finding]):
        self.path = path
        self.findings = findings
        self.stack: List[str] = []
        self._is_shim = path.replace("\\", "/").endswith(_SHIM_PATHS)
        # (has_cleanup, in_return) lexical context for spawn calls
        self._cleanup_depth = 0
        self._return_depth = 0

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

    # ---- deprecated imports -------------------------------------------
    def _flag_module(self, node: ast.AST, module: str) -> None:
        hit = _deprecated(module)
        if hit is not None and not self._is_shim:
            dep, repl = hit
            self.findings.append(Finding(
                "deprecated-import", self.path, node.lineno,
                self.qualname, dep,
                f"import of deprecated shim {dep}; use {repl}"))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._flag_module(node, alias.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if _deprecated(mod) is not None:
            self._flag_module(node, mod)
            return                  # one finding per statement is enough
        # `from repro.core import realproc` names the shim as the symbol
        for alias in node.names:
            if mod:
                self._flag_module(node, f"{mod}.{alias.name}")

    # ---- spawn/teardown pairing ---------------------------------------
    def visit_Try(self, node: ast.Try) -> None:
        covered = bool(node.finalbody) \
            or any(_handler_tears_down(h) for h in node.handlers)
        if covered:
            self._cleanup_depth += 1
        self.generic_visit(node)
        if covered:
            self._cleanup_depth -= 1

    def visit_Return(self, node: ast.Return) -> None:
        self._return_depth += 1
        self.generic_visit(node)
        self._return_depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name in SPAWN_CALLS and self._cleanup_depth == 0 \
                and self._return_depth == 0:
            self.findings.append(Finding(
                "popen-teardown", self.path, node.lineno, self.qualname,
                name,
                f"{name}(...) outside any try/finally (or "
                f"except+teardown) scope: an exception between spawn and "
                f"cleanup leaks live children"))
        self.generic_visit(node)


def check_module(tree: ast.Module, source: str, path: str
                 ) -> List[Finding]:
    findings: List[Finding] = []
    _ApiChecker(path, findings).visit(tree)
    return findings


def check_source(source: str, path: str = "<fixture>") -> List[Finding]:
    return check_module(ast.parse(source), source, path)


__all__ = ["check_module", "check_source", "DEPRECATED_MODULES",
           "SPAWN_CALLS"]

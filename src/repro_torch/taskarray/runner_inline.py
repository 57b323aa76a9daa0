# The port's copy of repro/taskarray/runner_inline.py: only the package prefix
# of its imports differs.
"""Deprecation shim: InlineRunner now lives in repro.exec.inline.

The in-interpreter execution path moved to the unified execution layer
(repro.exec) alongside the sim and real-process backends. `InlineRunner`
remains as a thin alias so existing imports keep working; new code should
use `repro.exec.InlineBackend` (or `repro.exec.get_backend("inline")`).
"""
from __future__ import annotations

from repro_torch.exec.inline import InlineBackend


class InlineRunner(InlineBackend):
    """Legacy name for repro.exec.inline.InlineBackend (same constructor:
    sleep=True)."""


__all__ = ["InlineRunner"]

# The port's copy of repro/taskarray/runner_real.py: only the package prefix
# of its imports differs.
"""Deprecation shim: RealRunner now lives in repro.exec.procpool.

The persistent two-tier JSON-pipe pool and its WORKER/LAUNCHER protocol
moved to the unified execution layer: the protocol strings and WorkerPool
are defined once in repro.exec.pool (also serving core.realproc's one-shot
launch measurement), and the graph-execution machinery is
repro.exec.procpool.ProcPoolBackend. `RealRunner` / `WorkerPool` remain
as thin aliases so existing imports keep working; new code should use
`repro.exec.ProcPoolBackend` (or `repro.exec.get_backend("procpool")`).
"""
from __future__ import annotations

from repro_torch.exec.pool import WorkerPool
from repro_torch.exec.procpool import ProcPoolBackend


class RealRunner(ProcPoolBackend):
    """Legacy name for repro.exec.procpool.ProcPoolBackend (same
    constructor: n_launchers/workers_per_launcher/pool)."""


__all__ = ["RealRunner", "WorkerPool"]

# The port's copy of repro/taskarray/runner_sim.py: only the package prefix
# of its imports differs.
"""Deprecation shim: SimRunner now lives in repro.exec.sim.SimBackend.

The discrete-event array-run machinery moved to the unified execution
layer (repro.exec) so the sim, real-process and inline routes share one
protocol, one event stream and one retry/straggler implementation.
`SimRunner` remains as a thin alias so existing imports and subclasses
keep working; new code should use `repro.exec.SimBackend` (or
`repro.exec.get_backend("sim")`).
"""
from __future__ import annotations

from repro_torch.exec.sim import SimBackend


class SimRunner(SimBackend):
    """Legacy name for repro.exec.sim.SimBackend (same constructor:
    spec/strategy/prepositioned/max_nodes/user)."""


__all__ = ["SimRunner"]

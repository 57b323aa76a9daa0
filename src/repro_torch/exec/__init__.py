"""The execution-backend layer of the port (counterpart of ``repro.exec``).

  ExecBackend     the protocol: launch(LaunchPlan) -> LaunchReport,
                  run_graph(TaskGraph) -> GraphResult, close().
  InlineBackend   payloads run in this interpreter, sharing its CUDA
                  context, loaded kernels and prepositioned weights: how
                  ``launch.sweep`` submits its members.

``base``, ``chaos``, ``driver`` and ``inline`` are copies of the
reference's modules (the event stream, seeded fault plans, the one
retry/backoff/straggler/deadline state machine, the inline backend). The
reference's other backends (``sim``, ``procpool``/``real``) and the modules
behind them (``pool``, ``protocol``) are not ported: ``get_backend`` knows
only ``"inline"``.
"""
from __future__ import annotations

from .base import (COMPLETE, DISPATCH, FAULT, LOST, READY, RESPAWN, RETRY,
                   SUBMIT, BackendBase, EventLog, ExecBackend, ExecEvent,
                   LaunchPlan, LaunchReport)
from .chaos import (DELAY_NODE, DROP_RESULT, FAIL_DISPATCH, FAULT_KINDS,
                    HANG_WORKER, KILL_LAUNCHER, ChaosDispatchError, Fault,
                    FaultPlan, VirtualChaos)
from .driver import (ArrayDriver, SimTimerHost, SyncTimerHost,
                     ThreadTimerHost, TimerHost)
from .inline import InlineBackend

_BACKENDS = {"inline": InlineBackend}
_NOT_PORTED = ("sim", "procpool", "real")


def get_backend(name: str, **kwargs) -> ExecBackend:
    """Factory: ``'inline'``. The reference's other backends raise
    ``KeyError``."""
    if name in _NOT_PORTED:
        raise KeyError(f"backend {name!r} is not ported yet; the port has "
                       f"{sorted(_BACKENDS)}")
    if name not in _BACKENDS:
        raise KeyError(f"unknown backend {name!r}; "
                       f"choose from {sorted(_BACKENDS)}")
    return _BACKENDS[name](**kwargs)


__all__ = [
    "SUBMIT", "DISPATCH", "READY", "COMPLETE", "RETRY",
    "FAULT", "LOST", "RESPAWN",
    "ExecEvent", "EventLog", "LaunchPlan", "LaunchReport", "ExecBackend",
    "BackendBase", "InlineBackend", "get_backend",
    "Fault", "FaultPlan", "VirtualChaos", "ChaosDispatchError",
    "FAULT_KINDS", "KILL_LAUNCHER", "HANG_WORKER", "DROP_RESULT",
    "FAIL_DISPATCH", "DELAY_NODE",
    "ArrayDriver", "TimerHost", "SimTimerHost", "SyncTimerHost",
    "ThreadTimerHost",
]

"""The execution-backend layer of the port (counterpart of ``repro.exec``).

  ExecBackend     the protocol: launch(LaunchPlan) -> LaunchReport for
                  one-shot launch-time measurement, run_graph(TaskGraph)
                  -> GraphResult for many-task execution, close().
  SimBackend      discrete-event TX-Green (core.scheduler + the §III
                  launch strategies): time simulated, values real.
  ProcPoolBackend the persistent two-tier JSON-pipe worker pool on this
                  host (the WORKER/LAUNCHER protocol of exec.pool), also
                  the one-shot real-process launch-time harness behind
                  core.realproc.
  InlineBackend   payloads run in this interpreter, sharing its CUDA
                  context, loaded kernels and prepositioned weights: how
                  ``launch.sweep`` submits its members.

``base``, ``chaos``, ``driver``, ``inline``, ``pool``, ``procpool``,
``protocol`` and ``sim`` are copies of the reference's modules: the event
stream, seeded fault plans, the one retry/backoff/straggler/deadline state
machine, the worker pool, the declared event protocol (``check_trace``,
``validate_trace``) and the backends. The backends resolve lazily:
``sim`` imports ``repro_torch.core``, whose supervisor imports this
package back.
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
from .pool import LAUNCHER_SRC, WORKER_SRC, ReadinessTimeout, WorkerPool
from .protocol import (ProtocolError, TraceStats, Violation, check_trace,
                       load_and_group, validate_trace)

_BACKENDS = {}


def _backend_classes():
    """Late import: backend modules import repro_torch.taskarray (and
    ``sim`` repro_torch.core), which import this package back, so they
    resolve on first use."""
    if not _BACKENDS:
        from .inline import InlineBackend
        from .procpool import ProcPoolBackend
        from .sim import SimBackend
        _BACKENDS.update({"sim": SimBackend, "procpool": ProcPoolBackend,
                          "real": ProcPoolBackend, "inline": InlineBackend})
    return _BACKENDS


def get_backend(name: str, **kwargs) -> ExecBackend:
    """Factory: ``'sim'`` | ``'procpool'`` (alias ``'real'``) |
    ``'inline'``."""
    classes = _backend_classes()
    if name not in classes:
        raise KeyError(f"unknown backend {name!r}; "
                       f"choose from {sorted(classes)}")
    return classes[name](**kwargs)


def __getattr__(name):
    if name in ("SimBackend", "ProcPoolBackend", "InlineBackend"):
        for cls in _backend_classes().values():
            if cls.__name__ == name:
                return cls
    raise AttributeError(name)


__all__ = [
    "SUBMIT", "DISPATCH", "READY", "COMPLETE", "RETRY",
    "FAULT", "LOST", "RESPAWN",
    "ExecEvent", "EventLog", "LaunchPlan", "LaunchReport", "ExecBackend",
    "BackendBase", "WORKER_SRC", "LAUNCHER_SRC", "WorkerPool",
    "ReadinessTimeout", "SimBackend", "ProcPoolBackend", "InlineBackend",
    "get_backend",
    "Fault", "FaultPlan", "VirtualChaos", "ChaosDispatchError",
    "FAULT_KINDS", "KILL_LAUNCHER", "HANG_WORKER", "DROP_RESULT",
    "FAIL_DISPATCH", "DELAY_NODE",
    "ArrayDriver", "TimerHost", "SimTimerHost", "SyncTimerHost",
    "ThreadTimerHost",
    "ProtocolError", "TraceStats", "Violation", "check_trace",
    "validate_trace", "load_and_group",
]

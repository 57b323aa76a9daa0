# The port's copy of repro/exec/base.py: only the package prefix
# of its imports differs.
"""Shared backend contract: plans, reports, and the structured event stream.

This module is import-pure (stdlib only) so every layer — core, taskarray,
launch, benchmarks — can depend on it without cycles. A backend's clock is
its own (simulated seconds for SimBackend, time.monotonic() for the real
ones); events within one run are mutually comparable, never across runs.

Event vocabulary (the timestamps the paper's Figures 4-7 are built from):

  submit     work handed to the backend (an array, a launch plan)
  dispatch   the backend put it on its launch path (scheduler dispatch op,
             pipe write, inline call)
  ready      a launched process/node reported up (launch-measurement runs)
  complete   a task/launch reached a terminal state (`ok` says which)
  retry      a failure retry or straggler duplicate was issued
  fault      a fault fired: injected chaos, a launcher crash, a failed
             respawn, an opened circuit breaker (`detail` says which)
  lost       an in-flight attempt died with its launcher and was reported
             to the driver's fail-fast retry path (not the deadline)
  respawn    a dead launcher/node came back (pool respawn, sim outage end)

The LEGAL orderings of these kinds — the per-task attempt lifecycle,
retry budgets, nothing-after-terminal, respawn-needs-a-prior-fault — are
declared once in exec.protocol and enforced twice: statically (every
emit call site must name a declared constant and pass the kind's
required fields; see repro.analysis) and at runtime
(protocol.validate_trace replays any EventLog or loaded JSONL spool).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Protocol, \
    runtime_checkable

SUBMIT = "submit"
DISPATCH = "dispatch"
READY = "ready"
COMPLETE = "complete"
RETRY = "retry"
FAULT = "fault"
LOST = "lost"
RESPAWN = "respawn"


@dataclass
class ExecEvent:
    kind: str                        # submit|dispatch|ready|complete|retry|
                                     # fault|lost|respawn
    t: float                         # backend clock
    array: Optional[str] = None      # task-array name (graph runs)
    task: Optional[int] = None       # task index within the array
    attempt: int = 1
    ok: Optional[bool] = None        # terminal outcome (complete events)
    detail: Dict[str, Any] = field(default_factory=dict)


class EventLog:
    """Append-only, thread-safe event stream. ProcPoolBackend emits from
    pipe-reader threads, so every mutation takes the lock; reads return
    snapshots."""

    def __init__(self):
        self._events: List[ExecEvent] = []
        self._lock = threading.Lock()

    def emit(self, kind: str, t: float, **kw) -> ExecEvent:
        ev = ExecEvent(kind, t, **kw)
        with self._lock:
            self._events.append(ev)
        return ev

    def of(self, *kinds: str) -> List[ExecEvent]:
        with self._lock:
            return [e for e in self._events if e.kind in kinds]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._events:
                out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def span(self, *kinds: str) -> Optional[float]:
        """Last-minus-first timestamp over the given kinds (all if none)."""
        evs = self.of(*kinds) if kinds else list(self)
        if not evs:
            return None
        ts = [e.t for e in evs]
        return max(ts) - min(ts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __iter__(self) -> Iterator[ExecEvent]:
        with self._lock:
            return iter(list(self._events))

    # ---- offline spool (chaos runs, multi-backend diffing) ------------
    def to_jsonl(self, path: str, append: bool = False,
                 extra: Optional[Dict[str, Any]] = None) -> int:
        """Spool the stream to a JSONL file (one event per line) so chaos
        runs and multi-backend comparisons can be diffed offline. `extra`
        keys (e.g. {"backend": "sim"}) are merged into every record.
        Returns the number of events written."""
        events = list(self)
        with open(path, "a" if append else "w") as f:
            for e in events:
                rec = {"kind": e.kind, "t": e.t, "array": e.array,
                       "task": e.task, "attempt": e.attempt, "ok": e.ok,
                       "detail": e.detail}
                if extra:
                    rec.update(extra)
                f.write(json.dumps(rec) + "\n")
        return len(events)

    @classmethod
    def from_jsonl(cls, path: str) -> "EventLog":
        """Load a spooled stream back into an EventLog. Keys beyond the
        ExecEvent fields (the to_jsonl `extra`) land in `detail`, so a
        round trip through extra={"backend": ...} stays inspectable."""
        log = cls()
        fields = ("kind", "t", "array", "task", "attempt", "ok", "detail")
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                detail = dict(rec.get("detail") or {})
                detail.update({k: v for k, v in rec.items()
                               if k not in fields})
                log.emit(rec["kind"], rec["t"], array=rec.get("array"),
                         task=rec.get("task"),
                         attempt=rec.get("attempt", 1), ok=rec.get("ok"),
                         detail=detail)
        return log


@dataclass
class LaunchPlan:
    """One-shot 'bring up N_nodes x P processes' measurement request — the
    unified form of what core.launcher strategies, core.realproc and the
    sweep drivers each used to express privately."""
    n_nodes: int
    procs_per_node: int
    app: str = "python"              # launch-cost profile (sim backend)
    topology: str = "two-tier"       # flat | ssh-tree | two-tier
    prepositioned: bool = True       # sim backend: local-disk deps staged

    @property
    def total_procs(self) -> int:
        return self.n_nodes * self.procs_per_node


@dataclass
class LaunchReport:
    """The one stats shape every backend returns from launch(): replaces
    core.launcher.LaunchResult / core.realproc.RealLaunchResult / the
    supervisor's ad-hoc dicts. `events` carries the per-node/process
    submit/dispatch/ready timestamps the aggregate numbers derive from."""
    backend: str
    topology: str
    n_nodes: int
    procs_per_node: int
    t_submit: float
    t_ready: float                   # last process/node ready
    events: EventLog = field(default_factory=EventLog, repr=False)

    @property
    def total_procs(self) -> int:
        return self.n_nodes * self.procs_per_node

    @property
    def launch_time(self) -> float:
        return self.t_ready - self.t_submit

    @property
    def launch_rate(self) -> float:
        return self.total_procs / max(self.launch_time, 1e-9)

    def row(self) -> Dict[str, Any]:
        """Benchmark-friendly flat dict (what bench_* scripts emit)."""
        return {"backend": self.backend, "topology": self.topology,
                "nodes": self.n_nodes, "procs_per_node": self.procs_per_node,
                "launch_s": round(self.launch_time, 4),
                "rate_per_s": round(self.launch_rate, 1)}


@runtime_checkable
class ExecBackend(Protocol):
    """What every execution route implements. `run_graph` takes a
    repro.taskarray.TaskGraph and returns its GraphResult (with an
    `.events` EventLog attached); `launch` measures a one-shot N x P
    process bring-up. Backends are context managers; close() is
    idempotent."""
    name: str

    def launch(self, plan: LaunchPlan) -> LaunchReport: ...

    def run_graph(self, graph, policy=None): ...

    def close(self) -> None: ...


class BackendBase:
    """Shared plumbing: context-manager protocol and a no-op close."""
    name = "abstract"

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

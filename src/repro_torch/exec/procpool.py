# The port's copy of repro/exec/procpool.py: only the package prefix
# of its imports differs.
"""ProcPoolBackend: real OS processes behind the ExecBackend protocol.

One backend, two duties (what used to be split — duplicated — between
core.realproc and taskarray.runner_real):

  run_graph   a persistent two-tier worker pool on this host: one
              launcher per "node", W workers each, everything STAYS
              ALIVE — tasks stream to workers over stdin/stdout JSON
              lines instead of one fork per task. Launch cost is paid
              once per session (the paper's preposition step);
              steady-state dispatch is a pipe write.
  launch      one-shot launch-time measurement (flat vs two-tier with
              actual forks), delegating to exec.pool.launch_once.

Payloads are `cmd` expression strings evaluated in the worker with
`params`, `inputs`, `attempt`, `math`, `time`, `random` in scope; values
travel back as JSON (so they must be JSON-serializable). fn payloads
cannot cross the process boundary — graphs for this backend carry cmd.

Gather runs in the parent through the shared exec.driver.ArrayDriver
(threading timers, driver.ThreadTimerHost): this backend only writes task
messages to the pool and routes result lines back into the driver. Task
ids carry a per-run nonce so a reused pool can never deliver one graph's
late result into the next graph's same-named array, and the pool's
handlers are reset when the run ends.

Recovery: the pool is SELF-HEALING (exec.pool). A launcher that dies
mid-run reports each lost in-flight attempt straight into
ArrayDriver.lost() — the fail-fast retry path — and is respawned with
backoff behind a circuit breaker; RetryPolicy.task_deadline remains the
backstop for results lost inside a LIVE launcher (hung worker). Chaos
faults (exec.chaos.FaultPlan) are interpreted PHYSICALLY here: a real
SIGKILL of the launcher subprocess, a real worker-side hang, a dropped
result line, a raised dispatch.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional, Set, Tuple

from repro_torch.taskarray.api import GraphResult, TaskArray, TaskGraph, \
    gather_inputs
from repro_torch.taskarray.dag import topo_order
from repro_torch.taskarray.gather import RetryPolicy

from .base import FAULT, BackendBase, EventLog, LaunchPlan, LaunchReport
from .chaos import (DEFAULT_HANG_SECONDS, DELAY_NODE, DROP_RESULT,
                    FAIL_DISPATCH, HANG_WORKER, KILL_LAUNCHER,
                    ChaosDispatchError, FaultPlan)
from .driver import ArrayDriver, ThreadTimerHost
from .pool import WorkerPool, launch_once

_RUN_NONCE = itertools.count()           # per-run task-id namespace


class _ChaosMonitor:
    """Physical FaultPlan interpretation for one run: SIGKILL a pool
    launcher after K delivered completions of the target array, wedge a
    worker with a long sleep, swallow a result line, refuse a dispatch,
    slow a virtual node down. The self-healing pool + driver must then
    recover; tests pin the invariants (no hang, no zombie, no silently
    dropped task)."""

    def __init__(self, plan: FaultPlan, pool: WorkerPool, events: EventLog,
                 target: str):
        self.plan = plan
        self.pool = pool
        self.events = events
        self.target = target
        # deliver() runs on the pool's reader threads — one PER launcher,
        # so with >1 launcher the counters race without their own lock
        self.completions = 0                      # guarded-by: self._lock
        self._kills = [f for f in plan.faults     # guarded-by: self._lock
                       if f.kind == KILL_LAUNCHER]
        self._dropped: Set[Tuple[int, int]] \
            = set()                               # guarded-by: self._lock
        self._lock = threading.Lock()

    def _effects(self, kind: str, index: int, attempt: int):
        for f in self.plan.faults:
            if f.kind == kind and f.task == index and f.attempt == attempt:
                return f
        return None

    # ---- dispatch side ------------------------------------------------
    def tweak(self, index: int, attempt: int, msg: dict) -> dict:
        """Apply dispatch-side faults to one outgoing task message."""
        f = self._effects(FAIL_DISPATCH, index, attempt)
        if f is not None:
            self.events.emit(FAULT, time.monotonic(), array=self.target,
                             task=index, attempt=attempt,
                             detail={"chaos": FAIL_DISPATCH})
            raise ChaosDispatchError(
                f"chaos: dispatch of task {index} attempt {attempt} "
                f"refused")
        f = self._effects(HANG_WORKER, index, attempt)
        if f is not None:
            self.events.emit(FAULT, time.monotonic(), array=self.target,
                             task=index, attempt=attempt,
                             detail={"chaos": HANG_WORKER})
            msg["sleep"] = (msg.get("sleep") or 0.0) \
                + (f.seconds or DEFAULT_HANG_SECONDS)
        for f in self.plan.faults:
            if f.kind == DELAY_NODE \
                    and self.plan.launcher_of(index) == f.launcher:
                msg["sleep"] = (msg.get("sleep") or 0.0) + f.seconds
        return msg

    # ---- result side --------------------------------------------------
    def deliver(self, index: int, attempt: int) -> bool:
        """Called per routed result of the target array; False = the
        result line is chaos-dropped. Also the kill trigger: launcher L
        dies (real SIGKILL) once `after` completions have been seen."""
        f = self._effects(DROP_RESULT, index, attempt)
        fire = []                         # kills triggered by this result
        with self._lock:
            if f is not None and (index, attempt) not in self._dropped:
                self._dropped.add((index, attempt))
                self.events.emit(FAULT, time.monotonic(),
                                 array=self.target, task=index,
                                 attempt=attempt,
                                 detail={"chaos": DROP_RESULT})
                return False
            self.completions += 1
            for f in list(self._kills):
                if self.completions >= max(1, f.after):
                    self._kills.remove(f)
                    fire.append((f, self.completions))
        # the SIGKILL itself happens with the lock released: kill() can
        # block, and the victim's reader thread may call back in here
        for f, seen in fire:
            self.events.emit(FAULT, time.monotonic(), array=self.target,
                             detail={"chaos": KILL_LAUNCHER,
                                     "launcher": f.launcher,
                                     "after": seen})
            try:
                self.pool.launchers[f.launcher
                                    % len(self.pool.launchers)].kill()
            except OSError:
                pass
        return True


class _PoolArrayHost:
    """The pool side of one ArrayDriver: serialize task messages (with the
    run nonce in the id) and submit them to the WorkerPool. Dispatch
    errors (closed pool, no live launchers, chaos refusals) propagate to
    the driver as attempt failures."""

    def __init__(self, pool: WorkerPool, nonce: str, array: TaskArray,
                 inputs, monitor: Optional[_ChaosMonitor] = None):
        if array.cmd is None:
            raise ValueError(
                f"array {array.name!r} has no cmd payload; ProcPoolBackend "
                "workers are separate processes and cannot run fn callables")
        self.pool = pool
        self.nonce = nonce
        self.array = array
        self.inputs = inputs
        self.monitor = monitor

    def _msg(self, index: int, attempt: int) -> dict:
        spec = self.array.tasks[index]
        sleep = 0.0
        if attempt == 1 and spec.straggle_factor > 1.0:
            sleep = spec.work_seconds * (spec.straggle_factor - 1.0)
        return {"id": f"{self.nonce}:{self.array.name}:{index}:{attempt}",
                "expr": self.array.cmd, "params": spec.params,
                "inputs": self.inputs, "attempt": attempt, "sleep": sleep}

    def dispatch_one(self, driver: ArrayDriver, index: int, attempt: int,
                     straggler: bool) -> None:
        msg = self._msg(index, attempt)
        if self.monitor is not None:
            msg = self.monitor.tweak(index, attempt, msg)
        self.pool.submit(msg)


class ProcPoolBackend(BackendBase):
    """Runs TaskGraphs on this host through one persistent WorkerPool.
    Arrays execute in topological order; the pool outlives every array (and
    every graph), which is the whole point — dispatch without re-launch.
    Close with .close() or use as a context manager."""

    name = "procpool"

    def __init__(self, n_launchers: int = 2, workers_per_launcher: int = 4,
                 pool: Optional[WorkerPool] = None, respawn: bool = True,
                 **pool_kwargs):
        self._pool_args = (n_launchers, workers_per_launcher)
        self._pool_kwargs = dict(respawn=respawn, **pool_kwargs)
        self.pool = pool
        self._owns_pool = pool is None

    def _ensure_pool(self) -> WorkerPool:
        if self.pool is None:
            self.pool = WorkerPool(*self._pool_args, **self._pool_kwargs)
        return self.pool

    def launch(self, plan: LaunchPlan) -> LaunchReport:
        """One-shot flat/two-tier launch-time measurement with real forks
        (the old core.realproc harness). Spawns its own processes; the
        persistent pool, if any, is untouched."""
        report, _procs = launch_once(plan.n_nodes, plan.procs_per_node,
                                     topology=plan.topology)
        return report

    def run_graph(self, graph: TaskGraph,
                  policy: Optional[RetryPolicy] = None,
                  chaos: Optional[FaultPlan] = None) -> GraphResult:
        policy = policy or RetryPolicy()
        pool = self._ensure_pool()
        nonce = f"r{next(_RUN_NONCE)}"
        events = EventLog()
        drivers: Dict[str, ArrayDriver] = {}
        first = graph.arrays[0].name if graph.arrays else ""
        monitors: Dict[str, _ChaosMonitor] = {}

        def parse(msg: dict):
            try:
                rn, rest = msg["id"].split(":", 1)
                name, index, attempt = rest.rsplit(":", 2)
            except (KeyError, ValueError):
                return None
            if rn != nonce:
                return None              # a previous run's late result
            return name, int(index), int(attempt)

        def route(msg: dict):
            parsed = parse(msg)
            if parsed is None:
                return
            name, index, attempt = parsed
            monitor = monitors.get(name)
            if monitor is not None and not monitor.deliver(index, attempt):
                return                   # chaos: result line lost
            driver = drivers.get(name)
            if driver is not None:
                driver.completion(index, attempt, bool(msg.get("ok")),
                                  value=msg.get("value"),
                                  error=msg.get("error"))

        def report_lost(msg: dict):
            # a launcher died with this attempt in flight: fail-fast into
            # the driver's retry path instead of waiting out task_deadline
            parsed = parse(msg)
            if parsed is None:
                return
            name, index, attempt = parsed
            driver = drivers.get(name)
            if driver is not None:
                driver.lost(index, attempt)

        def report_fault(kind: str, detail: dict):
            events.emit(kind, time.monotonic(), detail=detail)

        pool.set_handlers(on_result=route, on_lost=report_lost,
                          on_fault=report_fault)
        done = GraphResult()
        done.events = events
        try:
            for array in topo_order(graph.arrays):
                monitor = None
                if chaos is not None and chaos.targets(array.name, first):
                    monitor = _ChaosMonitor(chaos, pool, events, array.name)
                    monitors[array.name] = monitor
                host = _PoolArrayHost(pool, nonce, array,
                                      gather_inputs(array, done),
                                      monitor=monitor)
                driver = ArrayDriver(array, host.inputs, policy, events,
                                     ThreadTimerHost(),
                                     dispatch_one=host.dispatch_one)
                drivers[array.name] = driver
                driver.start()
                driver.wait()
                done[array.name] = driver.result()
        finally:
            # a reused pool must not keep routing into this (finished)
            # run: late results are dropped at the pool, not mis-routed
            pool.set_handlers()
        return done

    def close(self):
        if self.pool is not None and self._owns_pool:
            self.pool.close()
            self.pool = None

# The port's copy of repro/exec/inline.py: only the package prefix
# of its imports differs.
"""InlineBackend: execute a TaskGraph in THIS process, synchronously.

The degenerate but load-bearing third backend: no simulation, no worker
pool — fn payloads run right here, sharing the interpreter (and therefore
jax devices, compile caches, prepositioned weights). This is how the
hyperparameter sweep (launch.sweep, core.supervisor) submits its work as
a TaskArray and still gets the gather layer: per-task status, bounded
retries with backoff, and the unified event stream / summaries — all via
the shared exec.driver.ArrayDriver on a synchronous timer host
(driver.SyncTimerHost; sleep=False folds backoff waits into a virtual
clock offset for unit tests).

Stragglers are never re-dispatched here — not by a special case, but
because dispatch is synchronous: no task is ever still running when the
driver's straggler scan fires, so the shared state machine finds nothing
to duplicate. launch() is measured but trivial: "processes" are
in-interpreter no-ops, so the report mostly serves protocol conformance.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.taskarray.api import GraphResult, TaskArray, TaskGraph, \
    eval_cmd, gather_inputs
from repro_torch.taskarray.dag import topo_order
from repro_torch.taskarray.gather import RetryPolicy

from typing import Optional as _Optional

from .base import (READY, SUBMIT, BackendBase, EventLog, LaunchPlan,
                   LaunchReport)
from .chaos import (EFF_DELAY, EFF_DROP, EFF_FAIL_DISPATCH, EFF_LOST,
                    ChaosDispatchError, FaultPlan, VirtualChaos)
from .driver import ArrayDriver, SyncTimerHost


class _InlineArrayHost:
    """Synchronous dispatch: evaluating the payload IS the dispatch, and
    the completion is fed back before dispatch_one returns. Chaos effects
    (the virtual interpretation of a FaultPlan) apply at dispatch time:
    LOST reports straight into driver.lost(), DROP returns without a
    completion (the deadline/straggler machinery must rescue the task),
    FAIL_DISPATCH raises into the driver's dispatch-error retry path."""

    def __init__(self, array: TaskArray, inputs,
                 chaos: _Optional[VirtualChaos] = None):
        self.array = array
        self.inputs = inputs
        self.chaos = chaos

    def dispatch_one(self, driver: ArrayDriver, index: int, attempt: int,
                     straggler: bool) -> None:
        if self.chaos is not None:
            eff = self.chaos.effect(index, attempt)
            if eff is not None:
                self.chaos.applied(eff, driver.timers.now(), index, attempt)
                if eff.kind == EFF_FAIL_DISPATCH:
                    raise ChaosDispatchError(
                        f"chaos: dispatch of task {index} attempt "
                        f"{attempt} refused")
                if eff.kind == EFF_LOST:
                    driver.lost(index, attempt)
                    return
                if eff.kind == EFF_DROP:
                    return               # no completion: deadline path
                if eff.kind == EFF_DELAY:
                    driver.timers.advance(eff.seconds)
        if driver.injected(index, attempt):
            driver.completion(index, attempt, False)
            return
        spec = self.array.tasks[index]
        try:
            if self.array.fn is not None:
                value = self.array.fn(spec.params, self.inputs)
            else:
                value = eval_cmd(self.array.cmd, spec.params, self.inputs,
                                 attempt)
        except Exception as e:
            driver.completion(index, attempt, False, error=repr(e))
            return
        driver.completion(index, attempt, True, value)


class InlineBackend(BackendBase):
    name = "inline"

    def __init__(self, sleep: bool = True):
        # sleep=False skips real backoff waits (unit tests)
        self.sleep = sleep

    def launch(self, plan: LaunchPlan) -> LaunchReport:
        events = EventLog()
        t0 = time.monotonic()
        events.emit(SUBMIT, t0, detail={"topology": "inline"})
        for i in range(plan.total_procs):
            events.emit(READY, time.monotonic(), task=i)
        return LaunchReport(backend=self.name, topology="inline",
                            n_nodes=plan.n_nodes,
                            procs_per_node=plan.procs_per_node,
                            t_submit=t0, t_ready=time.monotonic(),
                            events=events)

    def run_graph(self, graph: TaskGraph,
                  policy: Optional[RetryPolicy] = None,
                  chaos: Optional[FaultPlan] = None) -> GraphResult:
        policy = policy or RetryPolicy()
        events = EventLog()
        done = GraphResult()
        done.events = events
        first = graph.arrays[0].name if graph.arrays else ""
        for array in topo_order(graph.arrays):
            vchaos = None
            if chaos is not None and chaos.targets(array.name, first):
                vchaos = VirtualChaos(chaos, array.name, array.n_tasks,
                                      events)
            host = _InlineArrayHost(array, gather_inputs(array, done),
                                    chaos=vchaos)
            timers = SyncTimerHost(sleep=self.sleep)
            driver = ArrayDriver(array, host.inputs, policy, events, timers,
                                 dispatch_one=host.dispatch_one)
            driver.start()
            timers.drain(lambda d=driver: d.finished, label=array.name)
            done[array.name] = driver.result()
        return done

# The port's copy of repro/taskarray/api.py: only the package prefix
# of its imports differs.
"""User API: TaskSpec / TaskArray / TaskGraph — LLMapReduce-style arrays.

The paper's launch machinery exists to serve *many-task* workloads:
parameter sweeps, map/reduce data analysis, model-architecture search.
This is the layer that expresses them:

    g = TaskGraph("wordstats")
    shards = g.map(make_shard, [{"seed": i} for i in range(64)])
    counts = g.map(count_words, [{"i": i} for i in range(64)],
                   deps=[shards])
    top    = g.reduce(merge_counts, counts)
    out    = g.run(SimRunner())          # or RealRunner() / InlineRunner()

Arrays form a DAG (dag.py); runners execute ready arrays, gather results
(gather.py), retry failures with backoff, and re-dispatch stragglers.

Task payloads carry TWO forms so the same graph runs on every runner:

  fn(params, inputs)   a Python callable — used by SimRunner (values are
                       computed in-process while *time* is simulated) and
                       by InlineRunner.
  cmd                  a Python expression string evaluated in a worker
                       process with `params`, `inputs`, `attempt`, `math`,
                       `time`, `random` in scope — used by RealRunner,
                       whose workers are separate OS processes reached
                       over JSON pipes (values must be JSON-serializable).

If only one form is given, runners that need the other raise up front.

`inputs` passed to a task is {dep_array_name: [dep values...]} for arrays
with dependencies, else None — so task i of a map-over-upstream array
reads inputs["shards"][i].
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from . import dag
from .gather import ArrayResult, RetryPolicy

PayloadFn = Callable[[Dict[str, Any], Optional[Dict[str, list]]], Any]


@dataclass
class TaskSpec:
    """One task of an array. `work_seconds` is the simulated payload cost
    (SimRunner's cost model; ignored by real runners). Fault-injection
    knobs let tests/benchmarks exercise the retry and straggler paths:

      fail_attempts    the task FAILS on its first N attempts (SimRunner
                       and InlineRunner honor this directly; RealRunner
                       payloads can condition on `attempt` themselves)
      straggle_factor  SimRunner: attempt 1 runs this much slower — a slow
                       *node*, so a re-dispatched attempt runs at nominal
                       speed elsewhere.
    """
    index: int
    params: Dict[str, Any] = field(default_factory=dict)
    work_seconds: float = 0.01
    fail_attempts: int = 0
    straggle_factor: float = 1.0


@dataclass
class TaskArray:
    """N tasks sharing one payload, submitted/accounted as one unit
    (core.scheduler.ArrayJob in sim; one streamed batch in real)."""
    name: str
    tasks: List[TaskSpec]
    fn: Optional[PayloadFn] = None
    cmd: Optional[str] = None
    procs_per_task: int = 1
    app: str = "python"              # launch-cost profile (sim runner)
    deps: List["TaskArray"] = field(default_factory=list)

    def __post_init__(self):
        if self.fn is None and self.cmd is None:
            raise ValueError(f"array {self.name!r}: need fn and/or cmd")
        if not self.tasks:
            raise ValueError(f"array {self.name!r}: empty task list")

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def __hash__(self):
        return id(self)


class TaskGraph:
    """A DAG of task arrays built with map()/reduce(), run by a runner."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.arrays: List[TaskArray] = []
        self._names: Dict[str, TaskArray] = {}

    # ------------------------------------------------------------------
    def map(self, fn: Optional[PayloadFn] = None,
            params: Iterable[Dict[str, Any]] = (), *,
            cmd: Optional[str] = None, name: Optional[str] = None,
            work_seconds: float = 0.01, procs_per_task: int = 1,
            app: str = "python",
            deps: Sequence[TaskArray] = ()) -> TaskArray:
        """One task per params dict; `work_seconds` may be a scalar or set
        per task afterwards via array.tasks[i].work_seconds."""
        tasks = [TaskSpec(i, dict(p), work_seconds=work_seconds)
                 for i, p in enumerate(params)]
        return self._add(TaskArray(name or f"map{len(self.arrays)}", tasks,
                                   fn=fn, cmd=cmd,
                                   procs_per_task=procs_per_task, app=app,
                                   deps=list(deps)))

    def reduce(self, fn: Optional[PayloadFn] = None,
               source: Optional[TaskArray] = None, *,
               cmd: Optional[str] = None, name: Optional[str] = None,
               fan_in: Optional[int] = None, work_seconds: float = 0.01,
               procs_per_task: int = 1, app: str = "python") -> TaskArray:
        """Gather `source`'s values into ceil(N/fan_in) reducer tasks
        (fan_in=None -> ONE task over everything). Reducer task j gets
        params {"lo": .., "hi": ..} naming its slice of
        inputs[source.name]."""
        if source is None:
            raise ValueError("reduce() needs a source array")
        n = source.n_tasks
        width = n if fan_in is None else max(1, fan_in)
        bounds = [(lo, min(lo + width, n)) for lo in range(0, n, width)]
        tasks = [TaskSpec(j, {"lo": lo, "hi": hi},
                          work_seconds=work_seconds)
                 for j, (lo, hi) in enumerate(bounds)]
        return self._add(TaskArray(name or f"reduce{len(self.arrays)}",
                                   tasks, fn=fn, cmd=cmd,
                                   procs_per_task=procs_per_task, app=app,
                                   deps=[source]))

    def _add(self, array: TaskArray) -> TaskArray:
        if array.name in self._names:
            raise ValueError(f"duplicate array name {array.name!r}")
        self._names[array.name] = array
        self.arrays.append(array)
        return array

    # ------------------------------------------------------------------
    def validate(self) -> None:
        dag.validate(self.arrays)

    def run(self, runner, policy: Optional[RetryPolicy] = None,
            chaos=None) -> "GraphResult":
        """Validate, then hand the whole graph to the runner. `chaos`
        (an exec.chaos.FaultPlan) is forwarded only when set, so runners
        predating fault injection keep working."""
        self.validate()
        if chaos is not None:
            return runner.run_graph(self, policy or RetryPolicy(),
                                    chaos=chaos)
        return runner.run_graph(self, policy or RetryPolicy())


class GraphResult(dict):
    """{array name: ArrayResult}; insertion order = completion order."""

    @property
    def all_ok(self) -> bool:
        return all(r.all_ok for r in self.values())

    def report(self) -> str:
        return "\n".join(str(r.summary) for r in self.values())


def gather_inputs(array: TaskArray,
                  done: Dict[str, ArrayResult]) -> Optional[Dict[str, list]]:
    """The inputs dict a runner passes to `array`'s tasks (None if the
    array has no dependencies)."""
    if not array.deps:
        return None
    return {d.name: done[d.name].values for d in array.deps}


def eval_cmd(cmd: str, params: Dict[str, Any],
             inputs: Optional[Dict[str, list]], attempt: int) -> Any:
    """Evaluate a cmd payload the way a RealRunner worker does, so Sim and
    Inline runners can execute cmd-only graphs with identical semantics."""
    import math
    import random
    import time
    return eval(cmd, {"params": params, "inputs": inputs,
                      "attempt": attempt, "math": math, "random": random,
                      "time": time})

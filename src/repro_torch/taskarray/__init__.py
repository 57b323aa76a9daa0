"""Many-task orchestration (LLMapReduce-style): job arrays + DAGs + gather.

The port's copy of ``repro.taskarray``: "run these N parameterized tasks,
respecting dependencies, gathering results, retrying failures" expressed
once and executed on a ``repro_torch.exec`` backend. The port has one
backend, ``InlineBackend``, so the reference's deprecated runner shims
(``SimRunner``, ``RealRunner``, ``WorkerPool``, ``InlineRunner``) are left
out with the backends behind them.
"""
from .api import (GraphResult, TaskArray, TaskGraph, TaskSpec, eval_cmd,
                  gather_inputs)
from .dag import CycleError, ready_set, topo_order
from .gather import (ArrayResult, ArraySummary, RetryPolicy,
                     StragglerDetector, TaskResult, summarize)

__all__ = [
    "GraphResult", "TaskArray", "TaskGraph", "TaskSpec", "eval_cmd",
    "gather_inputs", "CycleError", "ready_set", "topo_order",
    "ArrayResult", "ArraySummary", "RetryPolicy", "StragglerDetector",
    "TaskResult", "summarize",
]

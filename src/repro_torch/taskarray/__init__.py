"""Many-task orchestration (LLMapReduce-style): job arrays + DAGs + gather.

The port's copy of ``repro.taskarray``: "run these N parameterized tasks,
respecting dependencies, gathering results, retrying failures,
re-dispatching stragglers" expressed once and executed on any
``repro_torch.exec`` backend: a simulated 648-node cluster (SimBackend),
a persistent real-process worker pool (ProcPoolBackend), or inline in
this interpreter (InlineBackend).

SimRunner / RealRunner / InlineRunner / WorkerPool remain as deprecation
shims over those backends (resolved lazily to keep the taskarray <->
exec import graph acyclic).
"""
from .api import (GraphResult, TaskArray, TaskGraph, TaskSpec, eval_cmd,
                  gather_inputs)
from .dag import CycleError, ready_set, topo_order
from .gather import (ArrayResult, ArraySummary, RetryPolicy,
                     StragglerDetector, TaskResult, summarize)

_LAZY = {
    "InlineRunner": "runner_inline",
    "RealRunner": "runner_real",
    "WorkerPool": "runner_real",
    "SimRunner": "runner_sim",
}


def __getattr__(name):
    """Runner shims import repro_torch.exec, whose backends import this
    package back: resolving them on first access keeps both import orders
    legal."""
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(name)


__all__ = [
    "GraphResult", "TaskArray", "TaskGraph", "TaskSpec", "eval_cmd",
    "gather_inputs", "CycleError", "ready_set", "topo_order",
    "ArrayResult", "ArraySummary", "RetryPolicy", "StragglerDetector",
    "TaskResult", "summarize", "InlineRunner", "RealRunner", "WorkerPool",
    "SimRunner",
]

# The port's copy of repro/taskarray/dag.py: only the package prefix
# of its imports differs.
"""Dependency DAG over task arrays: validation, topo order, ready sets.

The LLMapReduce workflow (arXiv 2008.02223) is a DAG of job arrays —
map stages feeding reduce stages feeding further maps. Arrays (not tasks)
are the dependency unit: array B may start only when every array in
B.deps has gathered. This module is pure graph logic; runners drive it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set


class CycleError(ValueError):
    """The dependency graph contains a cycle (names the arrays involved)."""


def validate(arrays: Sequence) -> None:
    """Every dep must be part of the graph; names must be unique; acyclic."""
    names = [a.name for a in arrays]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate array names: {dup}")
    known = set(id(a) for a in arrays)
    for a in arrays:
        for d in a.deps:
            if id(d) not in known:
                raise ValueError(
                    f"array {a.name!r} depends on {d.name!r}, "
                    f"which is not in the graph")
    topo_order(arrays)          # raises CycleError on a cycle


def topo_order(arrays: Sequence) -> List:
    """Kahn's algorithm; deterministic (submission order among ties).
    Raises CycleError naming the arrays stuck on a cycle."""
    indeg: Dict[int, int] = {id(a): len(a.deps) for a in arrays}
    dependents: Dict[int, List] = {id(a): [] for a in arrays}
    for a in arrays:
        for d in a.deps:
            dependents[id(d)].append(a)
    order, frontier = [], [a for a in arrays if indeg[id(a)] == 0]
    while frontier:
        a = frontier.pop(0)
        order.append(a)
        for b in dependents[id(a)]:
            indeg[id(b)] -= 1
            if indeg[id(b)] == 0:
                frontier.append(b)
    if len(order) != len(arrays):
        stuck = sorted(a.name for a in arrays if indeg[id(a)] > 0)
        raise CycleError(f"dependency cycle among arrays: {stuck}")
    return order


def ready_set(arrays: Sequence, done: Iterable) -> List:
    """Arrays whose deps are ALL done and which are not themselves done —
    the next wave a runner may submit (computed incrementally as arrays
    complete, so independent branches overlap)."""
    done_ids: Set[int] = {id(a) for a in done}
    return [a for a in arrays
            if id(a) not in done_ids
            and all(id(d) in done_ids for d in a.deps)]

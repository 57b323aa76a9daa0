# The port's copy of repro/core/events.py: only the package prefix
# of its imports differs.
"""Discrete-event simulation engine (virtual clock, heap of callbacks).

The paper's launch-scaling claims are statements about a 648-node cluster's
temporal behaviour; this engine lets us reproduce Figures 4-7 exactly from
first-principles cost models (see repro.core.cluster) and run the scheduler
(repro.core.scheduler) against synthetic workloads — on one CPU.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class Timer:
    """Cancellable handle for a scheduled callback (returned by Sim.schedule).

    Cancellation marks the entry dead in place; the heap lazily discards it
    when popped. This is what lets the scheduler/taskarray layers requeue a
    job or retry a task WITHOUT its stale completion callback firing later."""

    __slots__ = ("t", "fn", "cancelled")

    def __init__(self, t: float, fn: Callable[[], None]):
        self.t = t
        self.fn = fn
        self.cancelled = False

    @property
    def active(self) -> bool:
        return not self.cancelled and self.fn is not None


class Sim:
    def __init__(self):
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Timer]] = []
        self._seq = itertools.count()
        self._stopped = False

    def schedule(self, delay: float, fn: Callable[[], None]) -> Timer:
        assert delay >= 0, delay
        timer = Timer(self.now + delay, fn)
        heapq.heappush(self._heap, (timer.t, next(self._seq), timer))
        return timer

    def at(self, t: float, fn: Callable[[], None]) -> Timer:
        return self.schedule(max(0.0, t - self.now), fn)

    def cancel(self, timer: Optional[Timer]) -> bool:
        """Cancel a pending callback; returns False if it already fired
        (or was already cancelled / is None). Idempotent and None-safe so
        callers can unconditionally cancel whatever handle they hold."""
        if timer is None or not timer.active:
            return False
        timer.cancelled = True
        timer.fn = None          # drop the closure (and anything it pins)
        return True

    def run(self, until: Optional[float] = None) -> float:
        """Run events until the heap drains (or virtual time `until`)."""
        while self._heap and not self._stopped:
            t, _, timer = self._heap[0]
            if not timer.active:
                heapq.heappop(self._heap)     # lazily discard cancelled
                continue
            if until is not None and t > until:
                self.now = until
                return self.now
            heapq.heappop(self._heap)
            self.now = t
            fn, timer.fn = timer.fn, None     # mark fired
            fn()
        return self.now

    def stop(self):
        self._stopped = True


class Resource:
    """FIFO server with finite service rate (models Lustre, dispatch loops).

    request(n_items) -> completion time, accounting queueing backpressure:
    the resource serves `rate` items/second globally; requests queue.
    """

    def __init__(self, sim: Sim, rate: float, latency: float = 0.0):
        self.sim = sim
        self.rate = rate
        self.latency = latency
        self._free_at = 0.0
        self.served = 0

    def eta(self, n_items: float) -> float:
        """Completion time if n_items were requested now (no side effects)."""
        start = max(self.sim.now, self._free_at)
        return start + n_items / self.rate + self.latency

    def request(self, n_items: float) -> float:
        """Queue n_items; returns their completion time. Per-request latency
        is pipelined (adds to completion, not to server occupancy)."""
        start = max(self.sim.now, self._free_at)
        busy_until = start + n_items / self.rate
        self._free_at = busy_until
        self.served += n_items
        return busy_until + self.latency

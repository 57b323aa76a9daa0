# The port's copy of repro/taskarray/gather.py: only the package prefix
# of its imports differs.
"""Result gathering: per-task status, retries, stragglers, array summaries.

Shared bookkeeping for every runner. A runner drives its own clock (virtual
Sim time or wall time) and control flow; this module owns the data model:

  TaskResult          one task's terminal record (value/error, attempts,
                      timing, whether a straggler duplicate was issued)
  RetryPolicy         bounded retries with exponential backoff
  StragglerDetector   running-median duration tracker; a task is a
                      straggler once its elapsed time exceeds k x median
                      (the scheduler's §III re-dispatch rule, applied at
                      task granularity)
  ArraySummary        completion histogram, dispatch rate, makespan
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, List, Optional

OK = "ok"
FAILED = "failed"
PENDING = "pending"


@dataclass
class TaskResult:
    index: int
    status: str = PENDING            # pending -> ok | failed
    value: Any = None
    error: Optional[str] = None
    attempts: int = 0                # dispatches consumed (incl. duplicates)
    redispatched: bool = False       # a straggler duplicate was issued
    submitted_at: float = 0.0
    finished_at: Optional[float] = None

    @property
    def terminal(self) -> bool:
        return self.status in (OK, FAILED)

    @property
    def duration(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff + straggler re-dispatch
    thresholds. One policy object parameterizes a whole graph run; the
    state machine that enforces it lives in repro.exec.driver.ArrayDriver
    (one implementation, every backend)."""
    max_retries: int = 2             # retries AFTER the first attempt
    backoff: float = 0.25            # delay before retry #1 (seconds)
    backoff_factor: float = 2.0
    straggler_k: float = 3.0         # elapsed > k x median -> re-dispatch
    min_straggler_samples: int = 3   # median needs this many completions
    scan_period: float = 0.25        # straggler-scan / deadline cadence
    task_deadline: Optional[float] = None
    # ^ per-task wall budget from first submit; exceeded -> FAILED with a
    #   timeout error. This is what turns a dead launcher (a dispatch that
    #   will never produce a completion) into a result instead of an
    #   infinite gather wait. None disables.

    def delay(self, retry_number: int) -> float:
        """Backoff before the retry_number-th retry (1-based)."""
        return self.backoff * self.backoff_factor ** (retry_number - 1)

    def may_retry(self, attempts_used: int) -> bool:
        return attempts_used <= self.max_retries


class StragglerDetector:
    """Running median over completed-task durations (sorted insert; arrays
    here are 1e4-scale, not 1e7). Threshold is k x median once at least
    min_samples completions are in."""

    def __init__(self, k: float = 3.0, min_samples: int = 3):
        self.k = k
        self.min_samples = min_samples
        self._sorted: List[float] = []

    def update(self, duration: float) -> None:
        bisect.insort(self._sorted, duration)

    @property
    def n(self) -> int:
        return len(self._sorted)

    def median(self) -> Optional[float]:
        s = self._sorted
        if not s:
            return None
        mid = len(s) // 2
        return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])

    def threshold(self) -> Optional[float]:
        """Elapsed time beyond which a running task is a straggler, or None
        while there is not yet enough signal."""
        if len(self._sorted) < self.min_samples:
            return None
        return self.k * self.median()

    def is_straggler(self, elapsed: float) -> bool:
        thr = self.threshold()
        return thr is not None and elapsed > thr


@dataclass
class ArraySummary:
    name: str
    n_tasks: int
    ok: int
    failed: int
    retries: int                     # extra dispatches due to failures
    straggler_redispatches: int
    makespan: float                  # first submit -> last terminal
    dispatch_rate: float             # tasks/s through the dispatch path
    throughput: float                # completed tasks / makespan
    completion_hist: List[int] = field(default_factory=list)  # 10 bins
    lost: int = 0                    # attempts lost to dead launchers
    #   (reported through the driver's fail-fast lost() path; each one
    #   also consumed a retry or ended the task FAILED)

    def __str__(self) -> str:
        return (f"[{self.name}] {self.ok}/{self.n_tasks} ok "
                f"({self.failed} failed, {self.retries} retries, "
                f"{self.lost} lost, "
                f"{self.straggler_redispatches} straggler re-dispatches) "
                f"makespan={self.makespan:.3f}s "
                f"dispatch={self.dispatch_rate:.0f}/s "
                f"throughput={self.throughput:.0f}/s")


@dataclass
class ArrayResult:
    """What a runner returns per array: every task's record + the summary.
    `values` is index-ordered (None where a task ended FAILED) and is what
    downstream arrays in the DAG receive as input."""
    name: str
    results: List[TaskResult]
    summary: ArraySummary

    @property
    def values(self) -> List[Any]:
        return [r.value for r in self.results]

    @property
    def all_ok(self) -> bool:
        return all(r.status == OK for r in self.results)


def summarize(name: str, results: List[TaskResult], t0: float, t_end: float,
              dispatch_seconds: Optional[float] = None,
              straggler_redispatches: int = 0, bins: int = 10,
              lost: int = 0) -> ArraySummary:
    n = len(results)
    ok = sum(1 for r in results if r.status == OK)
    failed = sum(1 for r in results if r.status == FAILED)
    retries = sum(max(0, r.attempts - 1) for r in results) \
        - straggler_redispatches
    makespan = max(t_end - t0, 1e-9)
    hist = [0] * bins
    for r in results:
        if r.finished_at is None:
            continue
        frac = (r.finished_at - t0) / makespan
        hist[min(bins - 1, int(frac * bins))] += 1
    d_rate = n / max(dispatch_seconds, 1e-9) if dispatch_seconds else 0.0
    return ArraySummary(name=name, n_tasks=n, ok=ok, failed=failed,
                        retries=max(0, retries),
                        straggler_redispatches=straggler_redispatches,
                        makespan=makespan, dispatch_rate=d_rate,
                        throughput=ok / makespan, completion_hist=hist,
                        lost=lost)

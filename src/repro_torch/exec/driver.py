# The port's copy of repro/exec/driver.py: only the package prefix
# of its imports differs.
"""ArrayDriver: THE retry/backoff/straggler/deadline state machine.

One array's gather logic — per-task attempt accounting, bounded retries
with exponential backoff, straggler re-dispatch against the running
median, per-task wall deadlines, terminal counting, event emission and
the summary — implemented exactly once. Backends supply only

  dispatch_one(driver, index, attempt, straggler)   put one attempt on the
                                                    backend's launch path
  dispatch_all(driver)                              optional batch form of
                                                    the initial attempt-1
                                                    dispatch (the sim
                                                    backend submits ONE
                                                    ArrayJob; default is a
                                                    dispatch_one loop)

and feed completions back through `driver.completion(index, attempt, ok,
value/error, t)`. The driver never touches a clock directly: all timing
goes through a small TimerHost, so the same state machine runs on
simulated time (Sim events), wall time (threading.Timer) or a synchronous
queue (inline).

Semantics (identical on every backend — pinned by the conformance suite
in tests/test_exec_backends.py):

  attempts        dispatches consumed, INCLUDING straggler duplicates —
                  duplicates draw from the same bounded retry budget
  staleness       the newest attempt is authoritative: a completion whose
                  `attempt` != the task's current attempt is dropped
                  (straggler losers, results from superseded attempts) —
                  it must neither complete the task nor trigger a retry
  fail injection  TaskSpec.fail_attempts is enforced HERE: an otherwise-ok
                  completion with attempt <= fail_attempts becomes a
                  failure, uniformly across backends
  dispatch error  an exception raised by dispatch_one is an attempt
                  failure (fed back through the retry path), not a crash
                  on a timer thread
  deadline        RetryPolicy.task_deadline bounds a task's total wall
                  time from first submit; exceeded -> FAILED with a
                  timeout error (this is how a dead launcher surfaces as
                  a result instead of an infinite gather wait)
  lost            a backend that LEARNS an in-flight attempt died with
                  its launcher reports it through lost(index, attempt):
                  the attempt fails immediately into the retry machinery
                  (one backoff, not task_deadline). Stale reports — the
                  task already terminal, the attempt superseded, or the
                  task already waiting out a retry backoff — are dropped.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, List, Optional, Protocol, Set, \
    runtime_checkable

from repro_torch.taskarray.gather import (FAILED, OK, ArrayResult,
                                          RetryPolicy, StragglerDetector,
                                          TaskResult, summarize)

from .base import COMPLETE, DISPATCH, LOST, RETRY, SUBMIT, EventLog


# --------------------------------------------------------------------------
# TimerHost: the clock/timer seam between the driver and a backend
# --------------------------------------------------------------------------


@runtime_checkable
class TimerHost(Protocol):
    """What the driver needs from a clock: read it, schedule a callback,
    cancel a handle. cancel() must be idempotent and None-safe."""

    def now(self) -> float: ...

    def call_later(self, delay: float, fn: Callable[[], None]) -> Any: ...

    def cancel(self, handle: Any) -> None: ...


class SimTimerHost:
    """Simulated time: adapts repro.core.events.Sim (attribute `now`,
    cancellable schedule()) to the TimerHost protocol."""

    def __init__(self, sim):
        self.sim = sim

    def now(self) -> float:
        return self.sim.now

    def call_later(self, delay: float, fn: Callable[[], None]):
        return self.sim.schedule(delay, fn)

    def cancel(self, handle) -> None:
        self.sim.cancel(handle)


class ThreadTimerHost:
    """Wall time: time.monotonic() + daemon threading.Timer. Callbacks
    fire on timer threads; the driver serializes them under its own lock."""

    def now(self) -> float:
        return time.monotonic()

    def call_later(self, delay: float, fn: Callable[[], None]):
        t = threading.Timer(delay, fn)
        t.daemon = True
        t.start()
        return t

    def cancel(self, handle) -> None:
        if handle is not None:
            handle.cancel()


class SyncTimerHost:
    """Synchronous host for the inline backend: call_later enqueues on a
    heap; drain() fires due callbacks in order. Waits are either slept for
    real (sleep=True) or folded into a virtual clock offset (sleep=False,
    the unit-test mode) — now() stays monotonic either way, so event
    timestamps and backoff accounting look like wall time without the
    wall-time cost."""

    def __init__(self, sleep: bool = True):
        self._sleep = sleep
        self._offset = 0.0
        self._heap: List[list] = []          # [due, seq, fn, active]
        self._seq = itertools.count()

    def now(self) -> float:
        return time.monotonic() + self._offset

    def call_later(self, delay: float, fn: Callable[[], None]):
        entry = [self.now() + delay, next(self._seq), fn, True]
        heapq.heappush(self._heap, entry)
        return entry

    def cancel(self, handle) -> None:
        if handle is not None:
            handle[3] = False

    def drain(self, done: Callable[[], bool], label: str = "driver"
              ) -> None:
        """Fire pending timers in due order until `done()`. Every dispatch
        is synchronous here, so the heap emptying with `done()` still false
        means a dispatch produced neither a completion nor a timer — a
        driver/backend bug. That used to return silently (an inline run
        that 'hung then nothing'); now it raises, naming the work."""
        while not done():
            if not self._heap:
                raise RuntimeError(
                    f"SyncTimerHost.drain: timer queue empty but {label!r} "
                    f"is unfinished — a dispatched task produced no "
                    f"completion and no pending timer (driver/backend bug, "
                    f"or a dropped result with no task_deadline to catch "
                    f"it)")
            due, _, fn, active = heapq.heappop(self._heap)
            if not active:
                continue
            wait = due - self.now()
            if wait > 0:
                if self._sleep:
                    time.sleep(wait)
                else:
                    self._offset += wait
            fn()

    def advance(self, seconds: float) -> None:
        """Fold a virtual delay into the clock (chaos DELAY_NODE on the
        inline backend: the timestamps shift, no wall time passes)."""
        self._offset += max(0.0, seconds)


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

DispatchOne = Callable[["ArrayDriver", int, int, bool], None]
DispatchAll = Callable[["ArrayDriver"], None]


class ArrayDriver:
    """Owns one array's run from submit to summary. Thread-safe: the sim
    backend calls in from Sim callbacks, the procpool backend from pipe
    reader threads and threading.Timers, the inline backend re-enters
    synchronously from inside its own dispatch (the lock is reentrant)."""

    def __init__(self, array, inputs, policy: RetryPolicy, events: EventLog,
                 timers: TimerHost, dispatch_one: DispatchOne,
                 dispatch_all: Optional[DispatchAll] = None,
                 on_finish: Optional[Callable[[ArrayResult], None]] = None,
                 dispatch_seconds: Optional[Callable[[], Optional[float]]]
                 = None):
        self.array = array
        self.inputs = inputs
        self.policy = policy
        self.events = events
        self.timers = timers
        self._dispatch_one = dispatch_one          # analysis: callback
        self._dispatch_all = dispatch_all          # analysis: callback
        self._on_finish = on_finish                # analysis: callback
        self._dispatch_seconds = dispatch_seconds  # analysis: callback
        self.results = [TaskResult(i)              # guarded-by: self._cond
                        for i in range(array.n_tasks)]
        self.detector = StragglerDetector(         # guarded-by: self._cond
            policy.straggler_k, policy.min_straggler_samples)
        self.straggler_redispatches = 0            # guarded-by: self._cond
        self.lost_attempts = 0                     # guarded-by: self._cond
        self._dispatched_at = [0.0] * array.n_tasks  # guarded-by: self._cond
        self._in_backoff: Set[int] = set()         # guarded-by: self._cond
        self._retry_timers: List[Any] = []         # guarded-by: self._cond
        self._scan_timer: Any = None               # guarded-by: self._cond
        self._terminal = 0                         # guarded-by: self._cond
        self._done = False                         # guarded-by: self._cond
        self._finish_notified = False              # guarded-by: self._cond
        self._cond = threading.Condition(threading.RLock())
        self.t0 = 0.0                              # guarded-by: self._cond
        self._t_end = 0.0                          # guarded-by: self._cond
        self._dispatch_elapsed: Optional[float] \
            = None                                 # guarded-by: self._cond

    # ---- queries backends use to keep payload evaluation honest -------
    def is_current(self, index: int, attempt: int) -> bool:
        """False once the task is terminal or the attempt was superseded —
        backends skip payload evaluation for stale completions."""
        with self._cond:
            r = self.results[index]
            return not r.terminal and attempt == r.attempts

    def injected(self, index: int, attempt: int) -> bool:
        """Does TaskSpec.fail_attempts fault-inject this attempt? Backends
        that evaluate payloads in-process consult this to skip the eval."""
        return attempt <= self.array.tasks[index].fail_attempts

    @property
    def finished(self) -> bool:
        with self._cond:
            return self._done

    # ---- lifecycle ----------------------------------------------------
    def start(self) -> None:
        """Emit submit, dispatch every task at attempt 1, arm the scan."""
        with self._cond:
            # once the first attempt is on the launch path, backend threads
            # can reach this driver — the bookkeeping they read must be
            # published under the lock BEFORE any dispatch happens
            self.t0 = self.timers.now()
            for r in self.results:
                r.attempts = 1
                r.submitted_at = self.t0
            self._dispatched_at = [self.t0] * self.array.n_tasks
            self.events.emit(SUBMIT, self.t0, array=self.array.name,
                             detail={"n_tasks": self.array.n_tasks})
        # dispatch with the lock RELEASED: dispatch_one is backend code
        # (pipe writes, Sim submits) and may re-enter completion()
        if self._dispatch_all is not None:
            self._dispatch_all(self)
        else:
            for i in range(self.array.n_tasks):
                self._dispatch(i, 1, False)
        with self._cond:
            self._dispatch_elapsed = max(self.timers.now() - self.t0, 1e-9)
            self.events.emit(DISPATCH, self.timers.now(),
                             array=self.array.name,
                             detail={"dispatch_s": self._dispatch_elapsed})
            if not self._done:
                self._scan_timer = self.timers.call_later(
                    self.policy.scan_period, self._scan)
        self._fire_finish()

    def completion(self, index: int, attempt: int, ok: bool,
                   value: Any = None, error: Optional[str] = None,
                   t: Optional[float] = None) -> None:
        """Terminal report for one attempt. Stale attempts are dropped —
        they neither complete the task nor consume retry budget."""
        with self._cond:
            r = self.results[index]
            if r.terminal or attempt != r.attempts:
                return
            if t is None:
                t = self.timers.now()
            if self.injected(index, attempt):
                ok = False
                error = f"injected failure (attempt {attempt})"
            if ok:
                r.status = OK
                r.value = value
                r.finished_at = t
                self.detector.update(t - r.submitted_at)
                self.events.emit(COMPLETE, t, array=self.array.name,
                                 task=index, attempt=attempt, ok=True)
                self._finish_one()
            else:
                self._on_failure(index, attempt, error or "task failed", t)
            self._cond.notify_all()
        self._fire_finish()

    def lost(self, index: int, attempt: int) -> bool:
        """Fail-fast report: `attempt` of task `index` died in flight with
        its launcher and will never produce a completion. Feeds the normal
        retry machinery immediately (one backoff) instead of waiting out
        RetryPolicy.task_deadline. Returns True if the report was current
        and consumed; False if dropped as stale (task terminal, attempt
        superseded, or the task already sitting in retry backoff)."""
        with self._cond:
            r = self.results[index]
            if self._done or r.terminal or attempt != r.attempts \
                    or index in self._in_backoff:
                return False
            t = self.timers.now()
            self.lost_attempts += 1
            self.events.emit(LOST, t, array=self.array.name, task=index,
                             attempt=attempt)
            self._on_failure(index, attempt,
                             f"launcher lost attempt {attempt} in flight",
                             t)
            self._cond.notify_all()
        self._fire_finish()
        return True

    def wait(self) -> None:
        """Block (wall-clock backends) until every task is terminal."""
        with self._cond:
            while not self._done:
                self._cond.wait(timeout=self.policy.scan_period)

    def result(self) -> ArrayResult:
        """The gathered array (valid once finished)."""
        # consult the backend's dispatch-timing callback BEFORE taking the
        # lock — it is backend code and may take backend locks of its own
        override = None
        if self._dispatch_seconds is not None:
            override = self._dispatch_seconds()
        with self._cond:
            ds = self._dispatch_elapsed
            if override is not None:
                ds = override
            t_end = self._t_end if self._done else self.timers.now()
            summary = summarize(
                self.array.name, self.results, self.t0, t_end,
                dispatch_seconds=ds,
                straggler_redispatches=self.straggler_redispatches,
                lost=self.lost_attempts)
            return ArrayResult(self.array.name, self.results, summary)

    # ---- internals ----------------------------------------------------
    def _dispatch(self, index: int, attempt: int, straggler: bool) -> None:
        try:
            self._dispatch_one(self, index, attempt, straggler)
        except Exception as e:          # dead pool / closed backend:
            self._on_failure(index, attempt,    # an attempt failure, not
                             f"dispatch failed: {e!r}",   # a lost task
                             self.timers.now())

    def _on_failure(self, index: int, attempt: int, error: str,
                    t: float) -> None:
        with self._cond:
            r = self.results[index]
            r.error = error
            if self.policy.may_retry(r.attempts):
                self._in_backoff.add(index)
                self._retry_timers.append(self.timers.call_later(
                    self.policy.delay(r.attempts),
                    lambda: self._retry(index)))
            else:
                r.status = FAILED
                r.finished_at = t
                self.events.emit(COMPLETE, t, array=self.array.name,
                                 task=index, attempt=attempt, ok=False,
                                 detail={"error": error})
                self._finish_one()

    def _retry(self, index: int) -> None:
        with self._cond:
            r = self.results[index]
            if self._done or r.terminal:
                return
            self._in_backoff.discard(index)
            r.attempts += 1
            attempt = r.attempts
            self._dispatched_at[index] = self.timers.now()
            self.events.emit(RETRY, self._dispatched_at[index],
                             array=self.array.name, task=index,
                             attempt=attempt,
                             detail={"straggler": False})
            self._cond.notify_all()
        # dispatch with the lock released: r.attempts is already bumped, so
        # a completion racing in for the OLD attempt drops as stale
        self._dispatch(index, attempt, False)
        self._fire_finish()

    def _scan(self) -> None:
        """Periodic watchdog: per-task wall deadlines, then straggler
        re-dispatch (one duplicate per task; first CURRENT completion
        wins — see the staleness rule above)."""
        duplicates = []                  # (index, attempt) to dispatch
        with self._cond:
            if self._done:
                return
            now = self.timers.now()
            deadline = self.policy.task_deadline
            if deadline is not None:
                for i, r in enumerate(self.results):
                    if r.terminal:
                        continue
                    if now - r.submitted_at > deadline:
                        self._in_backoff.discard(i)
                        r.error = (f"task deadline exceeded: no result "
                                   f"within {deadline:g}s")
                        r.status = FAILED
                        r.finished_at = now
                        self.events.emit(COMPLETE, now,
                                         array=self.array.name, task=i,
                                         attempt=r.attempts, ok=False,
                                         detail={"error": r.error,
                                                 "timeout": True})
                        self._finish_one()
            if self._done:
                self._cond.notify_all()
            else:
                thr = self.detector.threshold()
                if thr is not None:
                    for i, r in enumerate(self.results):
                        if r.terminal or r.redispatched \
                                or i in self._in_backoff:
                            continue
                        if now - self._dispatched_at[i] > thr:
                            r.redispatched = True
                            r.attempts += 1
                            self.straggler_redispatches += 1
                            self._dispatched_at[i] = now
                            self.events.emit(RETRY, now,
                                             array=self.array.name,
                                             task=i, attempt=r.attempts,
                                             detail={"straggler": True})
                            duplicates.append((i, r.attempts))
                self._scan_timer = self.timers.call_later(
                    self.policy.scan_period, self._scan)
                self._cond.notify_all()
        # straggler duplicates go out with the lock released; the attempt
        # bump above already makes the superseded attempt stale
        for i, attempt in duplicates:
            self._dispatch(i, attempt, True)
        self._fire_finish()

    def _finish_one(self) -> None:    # guarded-by: self._cond
        """Caller holds self._cond. Marks progress; the LAST terminal task
        flips _done and cancels timers, but the user's on_finish callback
        fires later, from _fire_finish(), OUTSIDE the lock — invoking user
        code under _cond was a self-deadlock trap (a callback calling
        result()/wait() re-enters; one starting new work on another thread
        that needs this driver deadlocks for real)."""
        self._terminal += 1
        if self._terminal == len(self.results):
            self._done = True
            self._t_end = self.timers.now()
            self.timers.cancel(self._scan_timer)
            for h in self._retry_timers:
                self.timers.cancel(h)
            self._cond.notify_all()

    def _fire_finish(self) -> None:
        """Invoke on_finish exactly once, after the lock is released, on
        whichever thread drove the final task terminal."""
        with self._cond:
            if not self._done or self._finish_notified:
                return
            self._finish_notified = True
            fn = self._on_finish
        if fn is not None:
            fn(self.result())


__all__ = ["ArrayDriver", "TimerHost", "SimTimerHost", "ThreadTimerHost",
           "SyncTimerHost"]

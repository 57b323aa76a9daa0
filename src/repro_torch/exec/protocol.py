# The port's copy of repro/exec/protocol.py: only the package prefix
# of its imports differs.
"""The DECLARED event protocol: one state machine, checked two ways.

Every EventLog in this repo — sim, procpool, inline, chaos runs, JSONL
spools — is supposed to follow the same per-task lifecycle. Until now
that lifecycle lived implicitly in ArrayDriver's control flow and was
enforced only by example-based tests. This module declares it once:

  array   SUBMIT  -> DISPATCH (at most once each, SUBMIT first)
  task    implicit attempt 1 at array SUBMIT, then any of
            RETRY(attempt k)   only k == current+1 (failure retry or
                               straggler duplicate; duplicates draw from
                               the same budget, at most one per task)
            LOST(attempt k)    only for the CURRENT attempt
            COMPLETE(ok, k)    only for the CURRENT attempt; terminal —
                               nothing but informational FAULTs after
  fleet   FAULT anywhere; RESPAWN only after some FAULT or LOST (a slot
          cannot "come back" without having gone down on the record)
  launch  array=None streams (launch reports, the sweep supervisor):
          SUBMIT first, then DISPATCH / READY / COMPLETE

Checked statically (repro.analysis.events verifies every emit call site
names a declared kind and passes the kind's required fields) and at
runtime: validate_trace() replays any event stream — in-memory EventLog
or a JSONL spool loaded via EventLog.from_jsonl — against the machine.
The conformance and chaos suites run it on every log they produce, so
the source code and every recorded execution answer to the same
declared invariants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .base import (COMPLETE, DISPATCH, FAULT, LOST, READY, RESPAWN, RETRY,
                   SUBMIT, EventLog, ExecEvent)

#: every kind a conforming stream may contain, by declared constant name
KIND_BY_NAME: Dict[str, str] = {
    "SUBMIT": SUBMIT, "DISPATCH": DISPATCH, "READY": READY,
    "COMPLETE": COMPLETE, "RETRY": RETRY, "FAULT": FAULT, "LOST": LOST,
    "RESPAWN": RESPAWN,
}
EVENT_KINDS = frozenset(KIND_BY_NAME.values())

#: ExecEvent fields an emit of this kind MUST populate (statically checked
#: at every call site by repro.analysis.events, rechecked at replay)
REQUIRED_FIELDS: Dict[str, Tuple[str, ...]] = {
    COMPLETE: ("ok",),
    RETRY: ("attempt",),
    LOST: ("attempt",),
}

#: kinds that advance the per-task attempt machine (FAULT is
#: informational: chaos bookkeeping may trail the task's terminal event)
TASK_KINDS = (COMPLETE, RETRY, LOST)


@dataclass(frozen=True)
class Violation:
    index: int                       # position in the stream
    rule: str                        # unknown-kind | missing-field |
                                     # order | attempt | after-terminal |
                                     # retry-budget
    message: str
    kind: str = ""
    array: Optional[str] = None
    task: Optional[int] = None

    def __str__(self) -> str:
        where = f"event[{self.index}] {self.kind}"
        if self.array is not None:
            where += f" array={self.array!r}"
        if self.task is not None:
            where += f" task={self.task}"
        return f"{where}: [{self.rule}] {self.message}"


class ProtocolError(ValueError):
    """An event stream violated the declared protocol."""

    def __init__(self, violations: List[Violation]):
        self.violations = violations
        head = "\n  ".join(str(v) for v in violations[:10])
        more = len(violations) - 10
        if more > 0:
            head += f"\n  ... and {more} more"
        super().__init__(
            f"{len(violations)} event-protocol violation(s):\n  {head}")


@dataclass
class TraceStats:
    """What a valid replay learned about the stream (the summary the
    events_lint CLI prints)."""
    events: int = 0
    counts: Dict[str, int] = field(default_factory=dict)
    arrays: List[str] = field(default_factory=list)
    tasks: int = 0
    ok: int = 0
    failed: int = 0
    retries: int = 0
    stragglers: int = 0
    lost: int = 0
    faults: int = 0
    respawns: int = 0
    span: Optional[float] = None     # last - first timestamp

    def row(self) -> Dict[str, object]:
        return {"events": self.events, "arrays": len(self.arrays),
                "tasks": self.tasks, "ok": self.ok, "failed": self.failed,
                "retries": self.retries, "stragglers": self.stragglers,
                "lost": self.lost, "faults": self.faults,
                "respawns": self.respawns,
                "span_s": round(self.span, 4) if self.span else 0.0}


def check_trace(events: Iterable[ExecEvent],
                max_retries: Optional[int] = None
                ) -> Tuple[TraceStats, List[Violation]]:
    """Replay one event stream (in APPEND order — EventLog serializes
    appends under its lock, so append order is the authoritative order
    even when timestamps from different threads interleave) against the
    declared machine. Returns the stats plus every violation found; use
    validate_trace() for the raising form."""
    stats = TraceStats()
    out: List[Violation] = []

    def bad(i: int, e: ExecEvent, rule: str, msg: str) -> None:
        out.append(Violation(i, rule, msg, kind=e.kind, array=e.array,
                             task=e.task))

    submitted: Set[str] = set()          # arrays with a SUBMIT on record
    dispatched: Set[str] = set()
    run_submitted = False                # any array=None SUBMIT seen
    fault_or_lost = False                # RESPAWN precedence
    # (array, task) -> [current_attempt, terminal, plain_retries,
    #                   straggler_retries]
    tasks: Dict[Tuple[str, int], List] = {}
    ts: List[float] = []

    for i, e in enumerate(events):
        stats.events += 1
        stats.counts[e.kind] = stats.counts.get(e.kind, 0) + 1
        ts.append(e.t)
        if e.kind not in EVENT_KINDS:
            bad(i, e, "unknown-kind",
                f"kind {e.kind!r} is not declared in the protocol")
            continue
        for fname in REQUIRED_FIELDS.get(e.kind, ()):
            if getattr(e, fname) is None:
                bad(i, e, "missing-field",
                    f"{e.kind} events must carry {fname!r}")
        if e.kind == FAULT:
            stats.faults += 1
            fault_or_lost = True
        if e.kind == LOST:
            stats.lost += 1
            fault_or_lost = True
        if e.kind == RESPAWN:
            stats.respawns += 1
            if not fault_or_lost:
                bad(i, e, "order",
                    "respawn with no preceding fault or lost event")

        if e.array is None:
            # launch / supervisor style stream: loose ordering only
            if e.kind == SUBMIT:
                run_submitted = True
            elif e.kind in (DISPATCH, READY, COMPLETE, RETRY, LOST) \
                    and not run_submitted:
                bad(i, e, "order", f"{e.kind} before any submit")
            continue

        # array-scoped events
        if e.kind == SUBMIT:
            if e.array in submitted:
                bad(i, e, "order", "duplicate submit for this array "
                    "(merged spool? group by backend first)")
            submitted.add(e.array)
            stats.arrays.append(e.array)
            continue
        if e.array not in submitted:
            bad(i, e, "order", f"{e.kind} before the array's submit")
            continue
        if e.kind == DISPATCH:
            if e.array in dispatched:
                bad(i, e, "order", "duplicate dispatch for this array")
            dispatched.add(e.array)
            continue
        if e.task is None or e.kind not in TASK_KINDS:
            continue                     # array-level FAULT/RESPAWN etc.

        # ---- the per-task attempt machine -----------------------------
        key = (e.array, e.task)
        st = tasks.setdefault(key, [1, False, 0, 0])
        if st[1]:
            bad(i, e, "after-terminal",
                f"{e.kind} for a task already terminal")
            continue
        if e.kind == RETRY:
            if e.attempt != st[0] + 1:
                bad(i, e, "attempt", f"retry to attempt {e.attempt} but "
                    f"current attempt is {st[0]}")
            st[0] = e.attempt
            if e.detail.get("straggler"):
                st[3] += 1
                stats.stragglers += 1
                if st[3] > 1:
                    bad(i, e, "retry-budget",
                        "more than one straggler duplicate for one task")
            else:
                st[2] += 1
                stats.retries += 1
                if max_retries is not None and st[2] > max_retries:
                    bad(i, e, "retry-budget",
                        f"{st[2]} failure retries exceed the declared "
                        f"budget of {max_retries}")
        elif e.kind == LOST:
            if e.attempt != st[0]:
                bad(i, e, "attempt", f"lost attempt {e.attempt} but "
                    f"current attempt is {st[0]}")
        elif e.kind == COMPLETE:
            if e.attempt != st[0]:
                bad(i, e, "attempt", f"complete for attempt {e.attempt} "
                    f"but current attempt is {st[0]}")
            st[1] = True
            if e.ok:
                stats.ok += 1
            else:
                stats.failed += 1

    stats.tasks = len(tasks)
    if ts:
        stats.span = max(ts) - min(ts)
    return stats, out


def validate_trace(events: Iterable[ExecEvent],
                   max_retries: Optional[int] = None) -> TraceStats:
    """Raising form of check_trace: replay the stream, raise
    ProtocolError on any violation, return the TraceStats otherwise.
    `events` is an EventLog (or any iterable of ExecEvent, e.g. one
    loaded back from a JSONL spool)."""
    stats, violations = check_trace(events, max_retries=max_retries)
    if violations:
        raise ProtocolError(violations)
    return stats


def load_and_group(path: str) -> Dict[str, EventLog]:
    """Split a JSONL spool into one EventLog per `backend` tag (the
    `extra` key bench_taskarray.py --events-out stamps on each record);
    untagged records land under ''. A merged multi-run spool re-submits
    the same array names, so each group must be validated separately."""
    groups: Dict[str, EventLog] = {}
    for e in EventLog.from_jsonl(path):
        tag = str(e.detail.get("backend", ""))
        groups.setdefault(tag, EventLog()).emit(
            e.kind, e.t, array=e.array, task=e.task, attempt=e.attempt,
            ok=e.ok, detail=e.detail)
    return groups


__all__ = ["EVENT_KINDS", "KIND_BY_NAME", "REQUIRED_FIELDS", "TASK_KINDS",
           "Violation", "ProtocolError", "TraceStats", "check_trace",
           "validate_trace", "load_and_group"]

# The port's copy of repro/exec/chaos.py: only the package prefix
# of its imports differs.
"""repro.exec.chaos — deterministic, seeded fault injection for every
backend (the robustness analogue of the driver unification).

The recovery machinery — ArrayDriver's retry/deadline paths, the
WorkerPool's lost-task reporting and respawn — is only trustworthy if it
can be *systematically exercised*. A FaultPlan is a declarative, seeded
list of faults that all three backends interpret from one vocabulary:

  KILL_LAUNCHER  launcher L dies after K task completions
  HANG_WORKER    one attempt never returns (a worker wedged mid-payload)
  DROP_RESULT    one attempt's result line is lost on the wire
  FAIL_DISPATCH  one attempt's dispatch raises (scheduler RPC refused)
  DELAY_NODE     everything on one launcher/node runs `seconds` late

Two interpretation modes:

  real (ProcPoolBackend)      faults happen PHYSICALLY: KILL_LAUNCHER is
                              an actual SIGKILL of the launcher subprocess
                              (the self-healing pool must report the lost
                              in-flight attempts and respawn), HANG_WORKER
                              is a long worker-side sleep, DROP_RESULT is
                              swallowed in the parent's result router,
                              FAIL_DISPATCH raises ChaosDispatchError from
                              dispatch. The conformance suite checks the
                              recovery INVARIANTS here: no hang, no
                              zombie, no silently dropped task.

  virtual (Sim/InlineBackend) the plan is COMPILED to a deterministic
                              per-(task, attempt) effect map using a
                              shared virtual routing rule (task i lives on
                              launcher i % n_launchers; a dead launcher
                              takes its first `workers_per_launcher`
                              not-yet-completed tasks down with it), so
                              the SAME seeded plan yields IDENTICAL
                              terminal accounting — per-task attempts,
                              lost/retry/fault event counts — on both
                              backends, pinned by tests/test_chaos.py.

DELAY_NODE is a pure *time* effect (timestamps shift; accounting does not
change as long as the delay stays under the straggler threshold); on the
inline backend it advances the virtual clock.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set, Tuple

from .base import FAULT, LOST, RESPAWN, EventLog  # noqa: F401 (re-export)

KILL_LAUNCHER = "kill-launcher"
HANG_WORKER = "hang-worker"
DROP_RESULT = "drop-result"
FAIL_DISPATCH = "fail-dispatch"
DELAY_NODE = "delay-node"

FAULT_KINDS = (KILL_LAUNCHER, HANG_WORKER, DROP_RESULT, FAIL_DISPATCH,
               DELAY_NODE)

# default physical hang: long enough that only the driver's straggler /
# deadline machinery can rescue the task, short enough that an orphaned
# worker cannot outlive a test session by much
DEFAULT_HANG_SECONDS = 30.0
# default sim node-outage duration before recovery (simulated seconds)
DEFAULT_OUTAGE_SECONDS = 30.0


class ChaosDispatchError(RuntimeError):
    """Raised by a FAIL_DISPATCH fault in place of a real dispatch; the
    driver turns it into an attempt failure on the retry path."""


@dataclass(frozen=True)
class Fault:
    """One fault. Field meaning depends on `kind`:

      KILL_LAUNCHER  launcher=victim slot, after=completions before the
                     kill, seconds=outage duration (sim node recovery)
      HANG_WORKER    task/attempt=the wedged attempt, seconds=hang length
      DROP_RESULT    task/attempt=the attempt whose result line vanishes
      FAIL_DISPATCH  task/attempt=the refused dispatch
      DELAY_NODE     launcher=slow node, seconds=added latency
    """
    kind: str
    launcher: int = 0
    after: int = 0
    task: Optional[int] = None
    attempt: int = 1
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")


# virtual effect kinds a compiled plan assigns to one (task, attempt)
EFF_LOST = "lost"                    # the attempt died with its launcher
EFF_DROP = "drop"                    # completion suppressed (hang / drop)
EFF_FAIL_DISPATCH = "fail-dispatch"  # dispatch raises
EFF_DELAY = "delay"                  # completion shifted `seconds` later


@dataclass(frozen=True)
class Effect:
    kind: str                        # EFF_* above
    fault: Fault                     # the fault this effect compiles from
    seconds: float = 0.0


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded chaos schedule. `array` targets one array
    by name (None = the graph's first array). `n_launchers` /
    `workers_per_launcher` define the shared virtual routing model the
    sim/inline interpretation compiles against — match them to the real
    pool's shape when comparing against ProcPoolBackend."""
    faults: Tuple[Fault, ...] = ()
    n_launchers: int = 2
    workers_per_launcher: int = 2
    array: Optional[str] = None
    seed: Optional[int] = None

    @classmethod
    def seeded(cls, seed: int, n_tasks: int, *, n_launchers: int = 2,
               workers_per_launcher: int = 2,
               kinds: Tuple[str, ...] = (KILL_LAUNCHER, FAIL_DISPATCH),
               array: Optional[str] = None) -> "FaultPlan":
        """Generate one fault per requested kind from a seed — the same
        (seed, n_tasks, shape) always yields the same plan, so a chaos
        run is exactly reproducible across backends and sessions."""
        rng = random.Random(seed)
        faults = []
        for kind in kinds:
            if kind == KILL_LAUNCHER:
                faults.append(Fault(
                    KILL_LAUNCHER, launcher=rng.randrange(n_launchers),
                    after=rng.randrange(1, max(2, n_tasks // 2)),
                    seconds=DEFAULT_OUTAGE_SECONDS))
            elif kind in (HANG_WORKER, DROP_RESULT, FAIL_DISPATCH):
                faults.append(Fault(kind, task=rng.randrange(n_tasks),
                                    seconds=DEFAULT_HANG_SECONDS
                                    if kind == HANG_WORKER else 0.0))
            elif kind == DELAY_NODE:
                faults.append(Fault(DELAY_NODE,
                                    launcher=rng.randrange(n_launchers),
                                    seconds=0.05))
        return cls(tuple(faults), n_launchers=n_launchers,
                   workers_per_launcher=workers_per_launcher, array=array,
                   seed=seed)

    # ---- the shared virtual model -------------------------------------
    def launcher_of(self, index: int) -> int:
        """Virtual routing rule sim/inline share: task i lives on
        launcher i % n_launchers."""
        return index % max(1, self.n_launchers)

    def targets(self, array_name: str, first_array: str) -> bool:
        return (self.array or first_array) == array_name

    def compile(self, n_tasks: int) -> Dict[Tuple[int, int], Effect]:
        """Deterministic per-(task, attempt) effect map for the virtual
        interpretation. A KILL_LAUNCHER takes down the first
        `workers_per_launcher` tasks with index >= `after` that route to
        the victim (its in-flight window at the kill); the respawned /
        surviving capacity then serves their retries cleanly. First fault
        to claim a (task, attempt) wins."""
        effects: Dict[Tuple[int, int], Effect] = {}
        for f in self.faults:
            if f.kind == KILL_LAUNCHER:
                victims = [i for i in range(n_tasks)
                           if i >= f.after
                           and self.launcher_of(i) == f.launcher]
                for i in victims[:self.workers_per_launcher]:
                    effects.setdefault((i, 1), Effect(EFF_LOST, f))
            elif f.kind in (HANG_WORKER, DROP_RESULT):
                if f.task is not None and f.task < n_tasks:
                    effects.setdefault((f.task, f.attempt),
                                       Effect(EFF_DROP, f, f.seconds))
            elif f.kind == FAIL_DISPATCH:
                if f.task is not None and f.task < n_tasks:
                    effects.setdefault((f.task, f.attempt),
                                       Effect(EFF_FAIL_DISPATCH, f))
            elif f.kind == DELAY_NODE:
                for i in range(n_tasks):
                    if self.launcher_of(i) == f.launcher:
                        effects.setdefault((i, 1),
                                           Effect(EFF_DELAY, f, f.seconds))
        return effects


class VirtualChaos:
    """Per-array interpreter state for the VIRTUAL mode (sim + inline).
    Both backends consult `effect()` at the same points of the attempt
    lifecycle and report application through `applied()`, which emits the
    uniform FAULT/RESPAWN bookkeeping — one FAULT event per fault that
    fires, one RESPAWN per KILL_LAUNCHER once all its victims are
    reported. LOST events come from ArrayDriver.lost() itself, so the
    event accounting is identical across the two backends by
    construction."""

    def __init__(self, plan: FaultPlan, array_name: str, n_tasks: int,
                 events: EventLog,
                 on_kill: Optional[Callable[[Fault], None]] = None):
        self.plan = plan
        self.array_name = array_name
        self.events = events
        self.on_kill = on_kill            # sim: trigger the cluster outage
        self.effects = plan.compile(n_tasks)
        self._pending: Dict[Fault, int] = {}
        for eff in self.effects.values():
            self._pending[eff.fault] = self._pending.get(eff.fault, 0) + 1
        self._fired: Set[Fault] = set()

    def effect(self, index: int, attempt: int) -> Optional[Effect]:
        return self.effects.get((index, attempt))

    def applied(self, eff: Effect, t: float, index: int,
                attempt: int) -> None:
        f = eff.fault
        if f not in self._fired:
            self._fired.add(f)
            self.events.emit(FAULT, t, array=self.array_name, task=index,
                             attempt=attempt,
                             detail={"chaos": f.kind,
                                     "launcher": f.launcher})
            if f.kind == KILL_LAUNCHER and self.on_kill is not None:
                self.on_kill(f)
        self._pending[f] -= 1
        if self._pending[f] == 0 and f.kind == KILL_LAUNCHER:
            # every in-flight victim reported: the launcher slot is back
            self.events.emit(RESPAWN, t, array=self.array_name,
                             detail={"launcher": f.launcher,
                                     "chaos": f.kind})


__all__ = ["KILL_LAUNCHER", "HANG_WORKER", "DROP_RESULT", "FAIL_DISPATCH",
           "DELAY_NODE", "FAULT_KINDS", "Fault", "FaultPlan", "Effect",
           "EFF_LOST", "EFF_DROP", "EFF_FAIL_DISPATCH", "EFF_DELAY",
           "VirtualChaos", "ChaosDispatchError", "DEFAULT_HANG_SECONDS",
           "DEFAULT_OUTAGE_SECONDS"]

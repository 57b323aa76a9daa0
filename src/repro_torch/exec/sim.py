# The port's copy of repro/exec/sim.py: only the package prefix
# of its imports differs.
"""SimBackend: the discrete-event cluster behind the ExecBackend protocol.

Wraps core.scheduler.Scheduler / core.cluster.Cluster and the §III launch
strategies (core.launcher). Each ready array is submitted as ONE
core.scheduler.ArrayJob (admitted and accounted like a Slurm job array);
per-task completion events feed the shared exec.driver.ArrayDriver, which
owns gather, bounded retries, straggler re-dispatch and deadlines — this
backend supplies only dispatch (ArrayJob submission) and completion
callbacks, on simulated timers (driver.SimTimerHost).

Time is simulated — a 648-node, 100k-task run takes milliseconds of wall
time — but VALUES are real: a task's fn/cmd payload is evaluated
in-process at its completion event, so the same DAG produces the same
answers here as on the ProcPoolBackend. That is what makes the sim backend
a design tool: makespans, retry counts and dispatch rates for a planned
campaign, with the actual analysis code in the loop.
"""
from __future__ import annotations

from typing import List, Optional, Set

from repro_torch.core.cluster import Cluster, ClusterSpec, TX_GREEN
from repro_torch.core.events import Sim
from repro_torch.core.scheduler import AdmissionMode, JobState, Scheduler, \
    UserLimits
from repro_torch.taskarray.api import GraphResult, TaskArray, TaskGraph, \
    eval_cmd, gather_inputs
from repro_torch.taskarray.dag import ready_set
from repro_torch.taskarray.gather import ArrayResult, RetryPolicy

from .base import (COMPLETE, DISPATCH, READY, SUBMIT, BackendBase,
                   EventLog, LaunchPlan, LaunchReport)
from .chaos import (DEFAULT_OUTAGE_SECONDS, EFF_DELAY, EFF_DROP,
                    EFF_FAIL_DISPATCH, EFF_LOST, Fault, FaultPlan,
                    VirtualChaos)
from .driver import ArrayDriver, SimTimerHost


class _SimArrayHost:
    """The sim side of one ArrayDriver: submit ArrayJobs (one N-task job
    at attempt 1, single-task follow-ups for retries/duplicates) and turn
    scheduler completion events into driver completions, evaluating the
    payload in-process at completion time.

    Chaos effects (the virtual FaultPlan interpretation, shared with the
    inline backend) apply where the simulated cluster reports each
    attempt: LOST reports into driver.lost() at the moment the dead
    launcher would have returned the result, DROP suppresses the
    completion (deadline/straggler rescue), FAIL_DISPATCH fails the
    attempt, DELAY re-schedules the completion later. A KILL_LAUNCHER
    additionally takes the corresponding simulated NODE down for the
    fault's outage window (Cluster.outage), so retries run on reduced
    capacity until recovery — the sim twin of a respawning launcher."""

    def __init__(self, backend: "SimBackend", sched: Scheduler,
                 array: TaskArray, chaos: Optional[VirtualChaos] = None):
        self.backend = backend
        self.sched = sched
        self.array = array
        self.chaos = chaos
        self._chaos_applied: Set[tuple] = set()
        self.job = None                  # the attempt-1 ArrayJob

    def dispatch_all(self, driver: ArrayDriver) -> None:
        # attempt 1 runs at straggle_factor x work: a slow NODE, so any
        # re-dispatched attempt gets nominal work elsewhere
        work = [t.work_seconds * t.straggle_factor for t in self.array.tasks]
        self.job = self.sched.submit_array(
            self.backend.user, self.array.app, work,
            self.array.procs_per_task, attempt=1,
            max_nodes=self.backend.max_nodes,
            task_done=lambda i, a, t: self._task_done(driver, i, a, t))

    def dispatch_one(self, driver: ArrayDriver, index: int, attempt: int,
                     straggler: bool) -> None:
        if straggler:
            self.sched.stats.straggler_redispatches += 1
        spec = self.array.tasks[index]
        self.sched.submit_array(
            self.backend.user, self.array.app, [spec.work_seconds],
            self.array.procs_per_task, attempt=attempt, max_nodes=1,
            task_done=lambda _i, a, t: self._task_done(driver, index, a, t))

    def dispatch_seconds(self) -> Optional[float]:
        launch = self.job.launch if self.job is not None else None
        return launch.launch_time if launch is not None else None

    def _task_done(self, driver: ArrayDriver, index: int, attempt: int,
                   t: float) -> None:
        if not driver.is_current(index, attempt):
            return                       # straggler loser / stale attempt
        if self.chaos is not None and (index, attempt) \
                not in self._chaos_applied:
            eff = self.chaos.effect(index, attempt)
            if eff is not None:
                self._chaos_applied.add((index, attempt))
                self.chaos.applied(eff, t, index, attempt)
                if eff.kind == EFF_FAIL_DISPATCH:
                    driver.completion(index, attempt, False,
                                      error="chaos: dispatch refused", t=t)
                    return
                if eff.kind == EFF_LOST:
                    driver.lost(index, attempt)
                    return
                if eff.kind == EFF_DROP:
                    return               # deadline/straggler must rescue
                if eff.kind == EFF_DELAY:
                    self.sched.sim.schedule(
                        eff.seconds, lambda: self._task_done(
                            driver, index, attempt, t + eff.seconds))
                    return
        if driver.injected(index, attempt):
            driver.completion(index, attempt, False, t=t)
            return
        spec = self.array.tasks[index]
        try:
            if self.array.fn is not None:
                value = self.array.fn(spec.params, driver.inputs)
            else:
                value = eval_cmd(self.array.cmd, spec.params, driver.inputs,
                                 attempt)
        except Exception as e:           # payload bug: real failure path
            driver.completion(index, attempt, False, error=repr(e), t=t)
            return
        driver.completion(index, attempt, True, value, t=t)


class SimBackend(BackendBase):
    """Runs TaskGraphs / launch plans on the simulated cluster (default:
    TX-Green, 648 nodes, two-tier dispatch). Independent DAG branches
    overlap in sim time; each completing array unblocks its dependents
    immediately."""

    name = "sim"

    def __init__(self, spec: ClusterSpec = TX_GREEN,
                 strategy: str = "two-tier", prepositioned: bool = True,
                 max_nodes: Optional[int] = None, user: str = "analyst"):
        self.spec = spec
        self.strategy = strategy
        self.prepositioned = prepositioned
        self.max_nodes = max_nodes
        self.user = user
        self.sched: Optional[Scheduler] = None   # exposed for inspection

    # ------------------------------------------------------------------
    def _make_sched(self, sim: Sim, apps) -> Scheduler:
        cluster = Cluster(sim, self.spec)
        if self.prepositioned:
            for app in apps:
                cluster.preposition(app)
        whole = UserLimits(max_cores=self.spec.total_cores,
                           max_jobs=1 << 30, max_pending=1 << 30)
        return Scheduler(sim, cluster, mode=AdmissionMode.ON_DEMAND,
                         strategy=self.strategy, default_limits=whole)

    def launch(self, plan: LaunchPlan) -> LaunchReport:
        """Simulate one interactive launch on an idle cluster; the report's
        event stream carries per-node ready times (Figures 4-7 fodder)."""
        sim = Sim()
        cluster = Cluster(sim, self.spec)
        if plan.prepositioned:
            cluster.preposition(plan.app)
        whole = UserLimits(max_cores=self.spec.total_cores,
                           max_jobs=1 << 30, max_pending=1 << 30)
        strategy = plan.topology or self.strategy
        sched = Scheduler(sim, cluster, mode=AdmissionMode.ON_DEMAND,
                          strategy=strategy, default_limits=whole)
        events = EventLog()
        events.emit(SUBMIT, sim.now, detail={"topology": strategy})
        job = sched.submit(self.user, plan.app, plan.n_nodes,
                           plan.procs_per_node)
        sched.run()
        assert job.state == JobState.COMPLETED, job.state
        lr = job.launch
        events.emit(DISPATCH, job.started_at)
        for i, t in enumerate(lr.per_node_done):
            events.emit(READY, t, task=i)
        events.emit(COMPLETE, job.finished_at, ok=True)
        return LaunchReport(backend=self.name, topology=strategy,
                            n_nodes=plan.n_nodes,
                            procs_per_node=plan.procs_per_node,
                            t_submit=lr.t_submit, t_ready=lr.t_all_running,
                            events=events)

    def run_graph(self, graph: TaskGraph,
                  policy: Optional[RetryPolicy] = None,
                  chaos: Optional[FaultPlan] = None) -> GraphResult:
        policy = policy or RetryPolicy()
        sim = Sim()
        self.sched = self._make_sched(sim, {a.app for a in graph.arrays})
        timers = SimTimerHost(sim)
        events = EventLog()
        done = GraphResult()
        done.events = events
        done_arrays: List[TaskArray] = []
        submitted: Set[str] = set()
        first = graph.arrays[0].name if graph.arrays else ""
        cluster = self.sched.cluster

        def node_outage(f: Fault) -> None:
            # the physical half of a virtual KILL_LAUNCHER: the sim node
            # goes down for the outage window, then recovers (capacity
            # model only — the event bookkeeping lives in VirtualChaos)
            cluster.outage(f.launcher % len(cluster.nodes),
                           f.seconds or DEFAULT_OUTAGE_SECONDS)

        def pump():
            for arr in ready_set(graph.arrays, done_arrays):
                if arr.name in submitted:
                    continue
                submitted.add(arr.name)
                vchaos = None
                if chaos is not None and chaos.targets(arr.name, first):
                    vchaos = VirtualChaos(chaos, arr.name, arr.n_tasks,
                                          events, on_kill=node_outage)
                host = _SimArrayHost(self, self.sched, arr, chaos=vchaos)
                driver = ArrayDriver(
                    arr, gather_inputs(arr, done), policy, events, timers,
                    dispatch_one=host.dispatch_one,
                    dispatch_all=host.dispatch_all,
                    on_finish=lambda res, a=arr: complete(a, res),
                    dispatch_seconds=host.dispatch_seconds)
                driver.start()

        def complete(arr: TaskArray, res: ArrayResult):
            done[arr.name] = res
            done_arrays.append(arr)
            pump()

        pump()
        sim.run()
        if len(done) != len(graph.arrays):
            stuck = [a.name for a in graph.arrays if a.name not in done]
            raise RuntimeError(f"graph stalled; incomplete arrays: {stuck}")
        return done

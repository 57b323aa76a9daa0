# The port's copy of repro/core/scheduler.py: only the package prefix
# of its imports differs.
"""The paper's system: a Slurm-like scheduler with interactive launches.

Figure 3 decomposition — four operational lifecycle tasks:

  JobLifecycle   receives jobs, queues them, prioritizes candidates
                 (queue-management policies + per-user resource LIMITS,
                 the paper's chosen point in the Fig-2 trade-off space)
  SchedulingTask periodically evaluates the head of the prioritized queue
                 (tunable *periodicity* and *depth*, §III "we experimented
                 with various queue evaluation periodicities and job queue
                 evaluation depth values") and allocates resources
  ResourceMgmt   tracks node state/availability (heartbeats, failures)
  JobExecution   dispatches via a launch strategy (flat / ssh-tree /
                 two-tier), monitors completion, re-dispatches stragglers,
                 requeues work lost to node failure, records stats

Everything runs on the discrete-event engine (repro.core.events.Sim), so a
648-node × 262,144-process launch is simulated exactly in milliseconds of
wall time, and the paper's Figures 4-7 are reproduced from first principles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from .apps import AppProfile, PROFILES
from .cluster import Cluster, ClusterSpec, Node, TX_GREEN
from .events import Sim, Timer
from .launcher import STRATEGIES, LaunchResult


class JobState(Enum):
    PENDING = "pending"
    HELD = "held"          # admission-limited (over user quota)
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


class AdmissionMode(Enum):
    """Figure 2: the batch <-> interactive trade-off quadrant."""
    BATCH = "batch"                  # queue everything; latency, no flooding
    RESERVATION = "reservation"      # batch + future window reservations
    ON_DEMAND = "on_demand"          # immediate w/ per-user limits (LLSC)
    FLOOD = "flood"                  # immediate, no limits (scheduler floods)


@dataclass
class Job:
    jid: int
    user: str
    app: AppProfile
    n_nodes: int
    procs_per_node: int
    priority: int = 0
    interactive: bool = True
    work_seconds: float = 0.0        # per-process payload runtime
    state: JobState = JobState.PENDING
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    launch: Optional[LaunchResult] = None
    nodes: List[Node] = field(default_factory=list)
    requeues: int = 0
    straggler_redispatches: int = 0
    _complete_timer: Optional[Timer] = field(default=None, repr=False)

    @property
    def total_procs(self) -> int:
        return self.n_nodes * self.procs_per_node

    @property
    def cores(self) -> int:
        """Cores accounted against the user limit (whole-node allocation)."""
        return self.n_nodes * 64

    @property
    def queue_wait(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    @property
    def launch_time(self) -> Optional[float]:
        return self.launch.launch_time if self.launch else None


@dataclass
class ArrayJob(Job):
    """A Slurm-style job array: N tasks admitted/queued/accounted as ONE
    unit (one queue entry, one max_jobs slot, one allocation), dispatched
    with ONE launch (the LLMapReduce pattern, arXiv 2008.02223).

    Tasks are placed round-robin over the array's nodes; each node runs its
    tasks `tasks_per_node` at a time (its parallel-slot capacity), so a task
    with round-robin rank r on its node starts in wave r // tasks_per_node.
    The wave model charges each later wave the task's own runtime — an
    approximation that is exact for uniform task work.

    `task_done(index, attempt, t)` fires at every task's completion time;
    the taskarray layer hangs gather/retry/straggler logic off it."""
    n_tasks: int = 0
    procs_per_task: int = 1
    tasks_per_node: int = 1
    task_work: Optional[List[float]] = None
    task_done: Optional[Callable[[int, int, float], None]] = None
    attempt: int = 1                 # forwarded to task_done (retry layers)

    def node_of(self, index: int) -> int:
        return index % self.n_nodes

    def wave_of(self, index: int) -> int:
        return (index // self.n_nodes) // max(1, self.tasks_per_node)


@dataclass
class UserLimits:
    """Per-user resource limits (paper T1) — token-bucket style caps that
    make ON_DEMAND admission safe against scheduler flooding."""
    max_cores: int = 16384           # concurrently-held cores
    max_jobs: int = 64               # concurrently-running jobs
    max_pending: int = 256           # queued-but-not-running jobs


@dataclass
class SchedulerStats:
    dispatched: int = 0
    completed: int = 0
    failed: int = 0
    requeued: int = 0
    held: int = 0
    sched_cycles: int = 0
    considered: int = 0              # queue entries examined across cycles
    straggler_redispatches: int = 0
    arrays: int = 0                  # ArrayJobs submitted
    array_tasks: int = 0             # tasks across all ArrayJobs


class Scheduler:
    """Slurm-analogue over the simulated cluster."""

    def __init__(self, sim: Sim, cluster: Cluster,
                 mode: AdmissionMode = AdmissionMode.ON_DEMAND,
                 strategy: str = "two-tier",
                 eval_period: Optional[float] = None,
                 eval_depth: Optional[int] = None,
                 limits: Optional[Dict[str, UserLimits]] = None,
                 default_limits: Optional[UserLimits] = None,
                 straggler_factor: float = 0.0,
                 on_event: Optional[Callable[[str, Job], None]] = None):
        self.sim = sim
        self.cluster = cluster
        spec = cluster.spec
        self.mode = mode
        self.strategy = STRATEGIES[strategy]()
        self.eval_period = (spec.sched_eval_period if eval_period is None
                            else eval_period)
        self.eval_depth = (spec.sched_eval_depth if eval_depth is None
                           else eval_depth)
        self.limits = limits or {}
        self.default_limits = default_limits or UserLimits()
        self.straggler_factor = straggler_factor
        self.on_event = on_event or (lambda kind, job: None)

        self.queue: List[Job] = []
        self.running: Dict[int, Job] = {}
        self.history: List[Job] = []
        self.stats = SchedulerStats()
        self._jid = 0
        self._user_cores: Dict[str, int] = {}
        self._user_running: Dict[str, int] = {}
        self._cycle_scheduled = False

    # ------------------------------------------------------------------
    # Job lifecycle management (task 1)
    # ------------------------------------------------------------------
    def submit(self, user: str, app, n_nodes: int, procs_per_node: int,
               *, priority: int = 0, interactive: bool = True,
               work_seconds: float = 0.0) -> Job:
        if isinstance(app, str):
            app = PROFILES[app]
        self._jid += 1
        job = Job(self._jid, user, app, n_nodes, procs_per_node,
                  priority=priority, interactive=interactive,
                  work_seconds=work_seconds, submitted_at=self.sim.now)
        lim = self._limits_for(user)
        pending = sum(1 for j in self.queue if j.user == user)
        if pending >= lim.max_pending:
            job.state = JobState.HELD
            self.stats.held += 1
            self.on_event("held", job)
        self.queue.append(job)

        if self.mode in (AdmissionMode.ON_DEMAND, AdmissionMode.FLOOD) \
                and job.interactive:
            # immediate evaluation — no waiting for the periodic cycle
            self.sim.schedule(0.0, self._schedule_cycle)
        else:
            self._ensure_cycle()
        return job

    def submit_array(self, user: str, app, task_work: List[float],
                     procs_per_task: int = 1, *, priority: int = 0,
                     interactive: bool = True, max_nodes: Optional[int] = None,
                     attempt: int = 1,
                     task_done: Optional[Callable[[int, int, float], None]]
                     = None) -> ArrayJob:
        """Array-aware submission (Slurm job arrays / LLMapReduce): one
        queue entry for N tasks. `task_work[i]` is task i's payload runtime;
        `task_done(i, attempt, now)` fires as each task completes.

        Node count is sized so every task gets `procs_per_task` concurrent
        processes in wave 0, capped by `max_nodes` (default: whole cluster);
        over the cap, tasks run in waves per node (see ArrayJob)."""
        if isinstance(app, str):
            app = PROFILES[app]
        n_tasks = len(task_work)
        assert n_tasks > 0
        node = self.cluster.spec.node
        slots = max(1, (node.cores * node.hyperthreads) // procs_per_task)
        cap = max_nodes if max_nodes is not None else self.cluster.spec.n_nodes
        n_nodes = max(1, min(cap, -(-n_tasks // slots)))
        tasks_on_busiest = -(-n_tasks // n_nodes)
        self._jid += 1
        job = ArrayJob(self._jid, user, app, n_nodes,
                       procs_per_node=min(tasks_on_busiest, slots)
                       * procs_per_task,
                       priority=priority, interactive=interactive,
                       work_seconds=max(task_work),
                       submitted_at=self.sim.now,
                       n_tasks=n_tasks, procs_per_task=procs_per_task,
                       tasks_per_node=slots, task_work=list(task_work),
                       task_done=task_done, attempt=attempt)
        self.stats.arrays += 1
        self.stats.array_tasks += n_tasks
        lim = self._limits_for(user)
        pending = sum(1 for j in self.queue if j.user == user)
        if pending >= lim.max_pending:
            job.state = JobState.HELD
            self.stats.held += 1
            self.on_event("held", job)
        self.queue.append(job)
        if self.mode in (AdmissionMode.ON_DEMAND, AdmissionMode.FLOOD) \
                and job.interactive:
            self.sim.schedule(0.0, self._schedule_cycle)
        else:
            self._ensure_cycle()
        return job

    def cancel(self, job: Job):
        if job.state == JobState.PENDING:
            job.state = JobState.CANCELLED
            self.queue.remove(job)
            self.history.append(job)

    def _limits_for(self, user: str) -> UserLimits:
        if self.mode == AdmissionMode.FLOOD:
            return UserLimits(max_cores=1 << 62, max_jobs=1 << 62,
                              max_pending=1 << 62)
        return self.limits.get(user, self.default_limits)

    def _priority_key(self, job: Job):
        """Queue-management policy: priority desc, then FIFO. Interactive
        jobs outrank batch at equal priority (the LLSC policy)."""
        return (-job.priority, not job.interactive, job.submitted_at, job.jid)

    # ------------------------------------------------------------------
    # Scheduling task (task 2): periodic, bounded-depth queue evaluation
    # ------------------------------------------------------------------
    def _ensure_cycle(self):
        if not self._cycle_scheduled:
            self._cycle_scheduled = True
            self.sim.schedule(self.eval_period, self._periodic)

    def _periodic(self):
        self._cycle_scheduled = False
        self._schedule_cycle()
        if self.queue:
            self._ensure_cycle()

    def _schedule_cycle(self):
        self.stats.sched_cycles += 1
        candidates = sorted((j for j in self.queue
                             if j.state == JobState.PENDING),
                            key=self._priority_key)
        # §III: evaluation depth — only the first `depth` candidates are
        # examined per cycle; deeper jobs wait for a later cycle.
        examined = candidates[:self.eval_depth]
        self.stats.considered += len(examined)
        for job in examined:
            lim = self._limits_for(job.user)
            if self._user_running.get(job.user, 0) >= lim.max_jobs:
                continue
            if (self._user_cores.get(job.user, 0) + job.cores
                    > lim.max_cores):
                continue
            nodes = self.cluster.alloc_nodes(job.n_nodes)
            if nodes is None:
                continue    # insufficient resources; try next candidate
            self._dispatch(job, nodes)

    # ------------------------------------------------------------------
    # Job execution (task 4): dispatch, completion, stragglers, failures
    # ------------------------------------------------------------------
    def _dispatch(self, job: Job, nodes: List[Node]):
        self.queue.remove(job)
        job.state = JobState.RUNNING
        job.started_at = self.sim.now
        job.nodes = nodes
        self.running[job.jid] = job
        self._user_cores[job.user] = (self._user_cores.get(job.user, 0)
                                      + job.cores)
        self._user_running[job.user] = self._user_running.get(job.user, 0) + 1
        self.stats.dispatched += 1

        job.launch = self.strategy.launch(self.cluster, nodes,
                                          job.procs_per_node, job.app)
        self.on_event("dispatch", job)

        if isinstance(job, ArrayJob):
            t_finish = self._dispatch_array_tasks(job)
        else:
            # payload: per-node completion = launch done + work; stragglers
            # run straggler_factor× slower, re-dispatched once detected.
            per_node_done = []
            n = len(nodes)
            for i, t_launch in enumerate(job.launch.per_node_done):
                work = job.work_seconds
                if self.straggler_factor > 1.0 and n > 1 and i == n - 1:
                    # deterministic single straggler on the last node
                    median = job.work_seconds
                    detect = t_launch + median * 1.5      # detection point
                    redo = job.work_seconds               # re-run elsewhere
                    t_done = detect + redo
                    job.straggler_redispatches += 1
                    self.stats.straggler_redispatches += 1
                else:
                    t_done = t_launch + work
                per_node_done.append(t_done)
            t_finish = max(per_node_done) if per_node_done else self.sim.now
        job._complete_timer = self.sim.at(t_finish,
                                          lambda j=job: self._complete(j))

    def _dispatch_array_tasks(self, job: ArrayJob) -> float:
        """Per-task completion events for an ArrayJob; returns array finish
        time. Task i starts when ITS node's launcher has its processes up
        (per_node_done round-robin) and runs for task_work[i] per wave."""
        t_finish = self.sim.now
        for i, work in enumerate(job.task_work):
            t_launch = job.launch.per_node_done[job.node_of(i)]
            t_done = t_launch + work * (job.wave_of(i) + 1)
            t_finish = max(t_finish, t_done)
            if job.task_done is not None:
                self.sim.at(t_done, lambda i=i, t=t_done, j=job:
                            j.task_done(i, j.attempt, t))
        return t_finish

    def _complete(self, job: Job):
        if job.state != JobState.RUNNING:
            return
        # node failure during run? -> requeue handled by fail_node()
        job.state = JobState.COMPLETED
        job.finished_at = self.sim.now
        self._release(job)
        self.stats.completed += 1
        self.history.append(job)
        self.on_event("complete", job)
        # resources freed -> try to schedule more work immediately
        if self.queue:
            self.sim.schedule(0.0, self._schedule_cycle)

    def _release(self, job: Job):
        self.running.pop(job.jid, None)
        self.cluster.release(job.nodes)
        self._user_cores[job.user] = max(
            0, self._user_cores.get(job.user, 0) - job.cores)
        self._user_running[job.user] = max(
            0, self._user_running.get(job.user, 0) - 1)

    # ---- fault tolerance --------------------------------------------------
    def fail_node(self, node_id: int):
        """Node dies: kill it in the cluster; requeue affected RUNNING jobs
        (checkpoint/restart is the payload's job — repro.train.Trainer)."""
        self.cluster.kill_node(node_id)
        victim = None
        for job in list(self.running.values()):
            if any(nd.id == node_id for nd in job.nodes):
                victim = job
                break
        if victim is None:
            return None
        victim.state = JobState.PENDING
        victim.requeues += 1
        victim.started_at = None
        # the first dispatch's completion event is now stale — cancel it so
        # it cannot complete the re-dispatched run early
        self.sim.cancel(victim._complete_timer)
        victim._complete_timer = None
        self._release(victim)
        # released nodes minus the dead one stay free for other work
        self.queue.append(victim)
        self.stats.requeued += 1
        self.on_event("requeue", victim)
        self.sim.schedule(0.0, self._schedule_cycle)
        return victim

    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> float:
        return self.sim.run(until)


# --------------------------------------------------------------------------
# convenience: one-shot interactive launch measurement (Figures 4-7)
# --------------------------------------------------------------------------
def measure_launch(app: str, n_nodes: int, procs_per_node: int, *,
                   strategy: str = "two-tier", prepositioned: bool = True,
                   spec: ClusterSpec = TX_GREEN,
                   eval_period: Optional[float] = None,
                   eval_depth: Optional[int] = None) -> LaunchResult:
    """Simulate one interactive launch on an idle TX-Green; returns its
    LaunchResult (launch_time, launch_rate)."""
    sim = Sim()
    cluster = Cluster(sim, spec)
    if prepositioned:
        cluster.preposition(app)
    whole_machine = UserLimits(max_cores=spec.total_cores,
                               max_jobs=1 << 30, max_pending=1 << 30)
    sched = Scheduler(sim, cluster, mode=AdmissionMode.ON_DEMAND,
                      strategy=strategy, eval_period=eval_period,
                      eval_depth=eval_depth, default_limits=whole_machine)
    job = sched.submit("analyst", app, n_nodes, procs_per_node)
    sched.run()
    assert job.state == JobState.COMPLETED, job.state
    return job.launch

"""The port's launch layer against the reference: the discrete-event
reproduction of TX-Green, the sim backend, the event protocol, the runner
shims and the import graph, on the CPU.

- The copies (``core/{events,cluster,apps,launcher,scheduler,realproc}``,
  ``exec/{sim,protocol,pool,procpool}``, ``taskarray/runner_*``) are held to
  the reference's syntax trees, docstrings dropped and ``repro.`` imports
  read as ``repro_torch.`` (``_tree`` of ``tests/test_torch_sweep.py``).
- The simulation is exact: the paper's five cells and a grid of apps,
  strategies, nodes and processes per node give ``==`` launch times,
  per-node completion times and process counts in both packages.
- The scheduler scenarios of ``tests/test_scheduler.py`` (interactive vs
  batch, the on-demand core limit, node-failure requeue, straggler
  redispatch, backfill) give the same ``SchedulerStats`` and job records.
- Task graphs on ``sim`` (a retried task; a seeded launcher kill) give the
  same values, per-task statuses and attempts, summaries and event counts
  in both packages, and the port's ``sim`` and ``inline`` account alike.
- The protocol's accepted and rejected streams get the same verdicts and
  ``TraceStats`` from both packages.
No test here compares wall-clock times.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.cluster as ref_cluster
import repro.core.events as ref_events
import repro.core.scheduler as ref_scheduler
import repro.exec as ref_exec
import repro.exec.base as ref_base
import repro.exec.protocol as ref_protocol
import repro.taskarray as ref_taskarray
import repro_torch.core.cluster as port_cluster
import repro_torch.core.events as port_events
import repro_torch.core.scheduler as port_scheduler
import repro_torch.exec as port_exec
import repro_torch.exec.base as port_base
import repro_torch.exec.protocol as port_protocol
import repro_torch.taskarray as port_taskarray
from repro_torch.core.apps import PROFILES
from test_torch_sweep import _graph, _tree

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF = (ref_events, ref_cluster, ref_scheduler)
PORT = (port_events, port_cluster, port_scheduler)
# straggler detection off: the accounting comes from the plan alone
NO_STRAG = dict(min_straggler_samples=10 ** 6)


# --------------------------------------------------------------------------
# the copies
# --------------------------------------------------------------------------
COPIES = ["core/events", "core/cluster", "core/apps", "core/launcher",
          "core/scheduler", "exec/sim", "exec/protocol", "exec/pool",
          "exec/procpool", "core/realproc", "taskarray/runner_sim",
          "taskarray/runner_real", "taskarray/runner_inline"]


@pytest.mark.parametrize("module", COPIES)
def test_launch_layer_copy_is_the_reference_module(module):
    want = _tree(SRC / "repro" / f"{module}.py", rename=True)
    got = _tree(SRC / "repro_torch" / f"{module}.py", rename=False)
    assert got == want


# --------------------------------------------------------------------------
# the discrete-event reproduction: exact parity
# --------------------------------------------------------------------------
def _launch(scheduler, app, n, p, strategy="two-tier", prepositioned=True):
    r = scheduler.measure_launch(app, n, p, strategy=strategy,
                                 prepositioned=prepositioned)
    return (r.launch_time, r.per_node_done, r.t_all_running, r.total_procs)


# the paper's cells (tests/test_scheduler.py:23-49): (app, nodes, procs per
# node, strategy, prepositioned), and the bound each must meet
PAPER_CELLS = {
    "tensorflow-32k": (("tensorflow", 512, 64, "two-tier", True),
                       lambda r: r.total_procs == 32768
                       and r.launch_time < 5.0),
    "octave-32k": (("octave", 512, 64, "two-tier", True),
                   lambda r: r.launch_time < 10.0),
    "octave-262k": (("octave", 512, 512, "two-tier", True),
                    lambda r: r.total_procs == 262144
                    and r.launch_time < 40.0),
    "octave-rate": (("octave", 512, 256, "two-tier", True),
                    lambda r: 4000 <= r.launch_rate <= 12000),
    "matlab-cold-flat": (("matlab", 625, 64, "flat", False),
                         lambda r: 1800 <= r.launch_time <= 3600),
}


@pytest.mark.parametrize("cell", sorted(PAPER_CELLS))
def test_paper_cell_matches_the_reference_exactly(cell):
    args, bound = PAPER_CELLS[cell]
    assert _launch(port_scheduler, *args) == _launch(ref_scheduler, *args)
    app, n, p, strategy, prepositioned = args
    r = port_scheduler.measure_launch(app, n, p, strategy=strategy,
                                      prepositioned=prepositioned)
    assert bound(r), (cell, r.launch_time, r.launch_rate)


@pytest.mark.parametrize("strategy", ["flat", "ssh-tree", "two-tier"])
def test_launch_grid_matches_the_reference_exactly(strategy):
    """``tests/test_launch_sim.py``'s invariant grid, every point, warm and
    cold, with the reference's invariants checked on the port."""
    for app in sorted(PROFILES):
        for n in (1, 2, 8, 64, 512):
            for p in (1, 4, 64, 256):
                for warm in (True, False):
                    got = _launch(port_scheduler, app, n, p, strategy, warm)
                    want = _launch(ref_scheduler, app, n, p, strategy, warm)
                    assert got == want, (app, n, p, warm)
                    launch_time, per_node, t_all, total = got
                    assert launch_time > 0 and total == n * p
                    assert len(per_node) == n and max(per_node) == t_all


def _sched(pkg, mode, n_nodes=8, **kw):
    events, cluster, scheduler = pkg
    sim = events.Sim()
    c = cluster.Cluster(sim, cluster.ClusterSpec(n_nodes=n_nodes))
    c.preposition("octave")
    c.preposition("python")
    return scheduler.Scheduler(sim, c, mode=getattr(scheduler.AdmissionMode,
                                                    mode), **kw)


def _job(j):
    return (j.jid, j.state.name, j.submitted_at, j.started_at,
            j.finished_at, j.queue_wait, j.launch_time, j.requeues,
            j.straggler_redispatches, [nd.id for nd in j.nodes])


def _interactive_vs_batch(pkg):
    on = _sched(pkg, "ON_DEMAND")
    ia = on.submit("u", "octave", 2, 4)
    on.run()
    batch = _sched(pkg, "BATCH", eval_period=2.0)
    b = batch.submit("u", "octave", 2, 4, interactive=False)
    batch.run()
    assert ia.queue_wait == 0.0 and b.queue_wait >= 2.0
    return [(on.stats, [_job(ia)]), (batch.stats, [_job(b)])]


def _core_limit(pkg):
    _, _, scheduler = pkg
    s = _sched(pkg, "ON_DEMAND",
               default_limits=scheduler.UserLimits(max_cores=2 * 64))
    j1 = s.submit("u", "octave", 2, 4, work_seconds=100.0)
    j2 = s.submit("u", "octave", 2, 4, work_seconds=1.0)
    s.run(until=50.0)
    mid = [_job(j1), _job(j2)]
    assert (j1.state.name, j2.state.name) == ("RUNNING", "PENDING")
    s.run()
    assert j2.state.name == "COMPLETED"
    return [(s.stats, mid + [_job(j1), _job(j2)])]


def _node_failure_requeue(pkg):
    s = _sched(pkg, "ON_DEMAND", n_nodes=4)
    job = s.submit("u", "octave", 2, 4, work_seconds=100.0)
    s.run(until=10.0)
    dead = job.nodes[0].id
    assert s.fail_node(dead) is job
    s.run()
    assert job.state.name == "COMPLETED" and job.requeues == 1
    assert all(nd.id != dead for nd in job.nodes)
    return [(s.stats, [_job(job)])]


def _straggler_redispatch(pkg):
    s = _sched(pkg, "ON_DEMAND", n_nodes=4, straggler_factor=3.0)
    job = s.submit("u", "octave", 4, 2, work_seconds=10.0)
    s.run()
    assert job.straggler_redispatches == 1
    return [(s.stats, [_job(job)])]


def _backfill(pkg):
    s = _sched(pkg, "ON_DEMAND", n_nodes=2)
    j1 = s.submit("u", "octave", 2, 2, work_seconds=5.0)
    j2 = s.submit("u", "octave", 2, 2, work_seconds=5.0)
    s.run()
    assert j2.started_at >= j1.finished_at
    return [(s.stats, [_job(j1), _job(j2)])]


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _interactive_vs_batch, _core_limit, _node_failure_requeue,
    _straggler_redispatch, _backfill)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_scenario_matches_the_reference(scenario):
    run = SCENARIOS[scenario]
    got = [(dataclasses.asdict(st), jobs) for st, jobs in run(PORT)]
    want = [(dataclasses.asdict(st), jobs) for st, jobs in run(REF)]
    assert got == want


# --------------------------------------------------------------------------
# task graphs on the sim backend
# --------------------------------------------------------------------------
def _kill_graph(taskarray, n=8):
    """``tests/test_chaos.py``'s dual graph: both payload forms."""
    g = taskarray.TaskGraph("chaos")
    g.map(lambda p, i: p["x"] * p["x"], [{"x": x} for x in range(n)],
          cmd="params['x'] * params['x']", name="a", work_seconds=0.01)
    return g


def _kill_plan(exec_pkg, seed, n=8):
    return exec_pkg.FaultPlan.seeded(seed, n, n_launchers=2,
                                     workers_per_launcher=2,
                                     kinds=(exec_pkg.KILL_LAUNCHER,))


def _outcome(exec_pkg, graph, policy, backend, chaos=None, **kwargs):
    """Values, per-task statuses and attempts, summaries and event counts
    of ``graph`` run on ``exec_pkg``'s ``backend``."""
    with exec_pkg.get_backend(backend, **kwargs) as b:
        res = graph.run(b, policy, chaos=chaos)
    out = {"events": res.events.counts(), "arrays": {}}
    for name, arr in res.items():
        s = arr.summary
        out["arrays"][name] = {
            "values": arr.values,
            "tasks": [(r.index, r.status, r.attempts, r.error)
                      for r in arr.results],
            "summary": (s.n_tasks, s.ok, s.failed, s.retries,
                        s.straggler_redispatches, s.lost)}
    return out


def test_sim_runs_a_graph_as_the_reference_does():
    def run(exec_pkg, taskarray):
        return _outcome(exec_pkg, _graph(taskarray),
                        taskarray.RetryPolicy(max_retries=2), "sim")
    got = run(port_exec, port_taskarray)
    assert got == run(ref_exec, ref_taskarray)
    squares = got["arrays"]["squares"]
    assert squares["values"] == [i * i for i in range(8)]
    assert squares["tasks"][3][2] == 2 and squares["summary"][3] == 1
    assert got["arrays"]["total"]["values"] == [140]


@pytest.mark.parametrize("seed", [0, 123])
def test_sim_seeded_kill_matches_the_reference(seed):
    def run(exec_pkg, taskarray):
        policy = taskarray.RetryPolicy(max_retries=3, backoff=0.01,
                                       scan_period=0.05, **NO_STRAG)
        return _outcome(exec_pkg, _kill_graph(taskarray), policy, "sim",
                        chaos=_kill_plan(exec_pkg, seed))
    got = run(port_exec, port_taskarray)
    assert got == run(ref_exec, ref_taskarray)
    a = got["arrays"]["a"]
    assert a["values"] == [x * x for x in range(8)]
    assert a["summary"][5] >= 1                      # lost
    assert got["events"].get(port_base.LOST, 0) == a["summary"][5]


def test_port_sim_and_inline_account_alike_under_one_plan():
    """``tests/test_chaos.py``'s virtual identity on the port: per-task
    status and attempts and LOST/RETRY/FAULT/COMPLETE counts."""
    plan = port_exec.FaultPlan.seeded(
        1, 8, n_launchers=2, workers_per_launcher=2,
        kinds=(port_exec.KILL_LAUNCHER, port_exec.FAIL_DISPATCH))
    policy = port_taskarray.RetryPolicy(max_retries=3, backoff=0.01,
                                        scan_period=0.05, **NO_STRAG)
    acc = {}
    for backend in ("sim", "inline"):
        kwargs = {"sleep": False} if backend == "inline" else {}
        with port_exec.get_backend(backend, **kwargs) as b:
            res = _kill_graph(port_taskarray).run(b, policy, chaos=plan)
        port_protocol.validate_trace(res.events)
        counts = res.events.counts()
        acc[backend] = {
            "tasks": [(r.status, r.attempts) for r in res["a"].results],
            **{k: counts.get(k, 0) for k in (port_base.LOST,
                                             port_base.RETRY,
                                             port_base.FAULT,
                                             port_base.COMPLETE)},
            "summary_lost": res["a"].summary.lost}
    assert acc["sim"] == acc["inline"]
    assert acc["sim"][port_base.LOST] >= 1
    assert all(s == "ok" for s, _ in acc["sim"]["tasks"])


# --------------------------------------------------------------------------
# the event protocol
# --------------------------------------------------------------------------
def _good(b, log):
    log.emit(b.SUBMIT, 0.0, array="a", detail={"n_tasks": 2})
    log.emit(b.DISPATCH, 0.1, array="a")
    log.emit(b.COMPLETE, 0.5, array="a", task=0, attempt=1, ok=True)
    log.emit(b.RETRY, 0.6, array="a", task=1, attempt=2,
             detail={"straggler": False})
    log.emit(b.LOST, 0.7, array="a", task=1, attempt=2)
    log.emit(b.FAULT, 0.7, array="a", detail={"chaos": "kill-launcher"})
    log.emit(b.RETRY, 0.8, array="a", task=1, attempt=3,
             detail={"straggler": True})
    log.emit(b.RESPAWN, 0.9, detail={"launcher": 0})
    log.emit(b.COMPLETE, 1.0, array="a", task=1, attempt=3, ok=False)


def _after_terminal(b, log):
    _good(b, log)
    log.emit(b.COMPLETE, 1.1, array="a", task=0, attempt=1, ok=True)


def _attempt_skip(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit(b.RETRY, 0.5, array="a", task=0, attempt=3)


def _stale_attempt(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit(b.RETRY, 0.5, array="a", task=0, attempt=2)
    log.emit(b.COMPLETE, 0.6, array="a", task=0, attempt=1, ok=True)


def _respawn_without_fault(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit(b.RESPAWN, 0.5, detail={"launcher": 1})


def _before_submit(b, log):
    log.emit(b.COMPLETE, 0.1, array="a", task=0, attempt=1, ok=True)


def _duplicate_submit(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit(b.SUBMIT, 0.1, array="a")


def _unknown_kind(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit("compelte", 0.5, array="a", task=0)


def _missing_field(b, log):
    log.emit(b.SUBMIT, 0.0, array="a")
    log.emit(b.COMPLETE, 0.5, array="a", task=0, attempt=1)


def _retries(straggler):
    def build(b, log):
        log.emit(b.SUBMIT, 0.0, array="a")
        for k in (2, 3):
            log.emit(b.RETRY, 0.1 * k, array="a", task=0, attempt=k,
                     detail={"straggler": straggler})
    return build


# name -> (stream, check_trace's max_retries, the rules it must break)
TRACES = {
    "good": (_good, 1, []),
    "after-terminal": (_after_terminal, None, ["after-terminal"]),
    "attempt-skip": (_attempt_skip, None, ["attempt"]),
    "stale-attempt": (_stale_attempt, None, ["attempt"]),
    "respawn-without-fault": (_respawn_without_fault, None, ["order"]),
    "before-submit": (_before_submit, None, ["order"]),
    "duplicate-submit": (_duplicate_submit, None, ["order"]),
    "unknown-kind": (_unknown_kind, None, ["unknown-kind"]),
    "missing-field": (_missing_field, None, ["missing-field"]),
    "retry-budget-1": (_retries(False), 1, ["retry-budget"]),
    "retry-budget-2": (_retries(False), 2, []),
    "second-straggler": (_retries(True), None, ["retry-budget"]),
}


def _trace(base, build):
    log = base.EventLog()
    build(base, log)
    return log


@pytest.mark.parametrize("name", sorted(TRACES))
def test_check_trace_gives_the_reference_verdict(name):
    build, max_retries, rules = TRACES[name]
    verdicts = []
    for base, protocol in ((port_base, port_protocol),
                           (ref_base, ref_protocol)):
        stats, violations = protocol.check_trace(_trace(base, build),
                                                 max_retries=max_retries)
        verdicts.append((dataclasses.asdict(stats),
                         [dataclasses.astuple(v) for v in violations]))
    assert verdicts[0] == verdicts[1]
    assert sorted({v[1] for v in verdicts[0][1]}) == rules
    trace = _trace(port_base, build)
    if rules:
        with pytest.raises(port_protocol.ProtocolError):
            port_protocol.validate_trace(trace, max_retries=max_retries)
    else:
        port_protocol.validate_trace(trace, max_retries=max_retries)


# --------------------------------------------------------------------------
# the import graph
# --------------------------------------------------------------------------
@pytest.mark.parametrize("first,second",
                         [("repro_torch.exec.sim", "repro_torch.taskarray"),
                          ("repro_torch.taskarray", "repro_torch.exec.sim"),
                          ("repro_torch.taskarray.runner_real",
                           "repro_torch.exec"),
                          ("repro_torch.core.realproc",
                           "repro_torch.taskarray")])
def test_import_order_has_no_cycle(first, second):
    """``tests/test_exec_backends.py:250-255`` on the port: ``exec.sim``
    imports ``repro_torch.core``, whose supervisor imports ``exec`` back,
    and the runner shims import ``exec``; either order must load, and
    neither loads jax or the reference."""
    code = (f"import {first}; import {second}; import sys\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_runner_shims_name_the_port_backends():
    from repro_torch.exec.inline import InlineBackend
    from repro_torch.exec.pool import WorkerPool as PoolWorkerPool
    from repro_torch.exec.procpool import ProcPoolBackend
    from repro_torch.exec.sim import SimBackend
    assert issubclass(port_taskarray.SimRunner, SimBackend)
    assert issubclass(port_taskarray.RealRunner, ProcPoolBackend)
    assert issubclass(port_taskarray.InlineRunner, InlineBackend)
    assert port_taskarray.WorkerPool is PoolWorkerPool
    from repro_torch.core import realproc
    from repro_torch.exec import pool
    assert realproc.WORKER is pool.WORKER_SRC
    assert realproc.LAUNCHER is pool.LAUNCHER_SRC
    assert realproc.launch_once is pool.launch_once

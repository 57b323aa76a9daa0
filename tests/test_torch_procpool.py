"""The port's real-process launch layer on the CPU: the two-tier worker pool
(``exec/pool.py``), its backend (``exec/procpool.py``), the one-shot
launch harness (``core/realproc.py``), and the kernel build's own child
processes (``kernels/build.py`` ``_run_all``).

- One ``cmd`` graph with a task that fails its first attempt runs on both
  packages' ``procpool``: equal values, statuses, attempts and event
  counts.
- A seeded ``KILL_LAUNCHER`` plan SIGKILLs a launcher mid-array (the
  acceptance run of ``tests/test_chaos.py:174`` without its wall-clock
  bound): every task ends ok with the right value, the pool counts one
  crash, the lost attempts show as ``LOST`` events, the trace replays
  against the declared protocol, and every launcher ever spawned is
  reaped.
- Flat and two-tier real launches complete and reap every process. No
  test compares launch rates: they follow the host's load.
Every test keeps to 2 launchers x 2 workers (or ``compare(2, 4)``) and
bounds its waits with the pool's readiness timeout, ``task_deadline`` or
a subprocess timeout.
"""
from __future__ import annotations

import subprocess

import pytest

import repro.exec as ref_exec
import repro.taskarray as ref_taskarray
import repro_torch.exec as port_exec
import repro_torch.taskarray as port_taskarray
from repro_torch.core import realproc
from repro_torch.exec.base import FAULT, LOST, LaunchPlan, LaunchReport
from repro_torch.exec.protocol import validate_trace
from repro_torch.kernels import build
from test_torch_launch import NO_STRAG, _outcome

POOL = dict(n_launchers=2, workers_per_launcher=2, ready_timeout=60.0)


def _cmd_graph(taskarray, n=6):
    """A map of n squares (task 2 fails its first attempt) and a sum."""
    g = taskarray.TaskGraph("procpool")
    sq = g.map(cmd="params['x'] * params['x']",
               params=[{"x": x} for x in range(n)], name="sq")
    sq.tasks[2].fail_attempts = 1
    g.reduce(source=sq, name="tot",
             cmd="sum(inputs['sq'][params['lo']:params['hi']])")
    return g


def test_procpool_runs_a_cmd_graph_as_the_reference_does():
    def run(exec_pkg, taskarray):
        policy = taskarray.RetryPolicy(max_retries=2, backoff=0.01,
                                       scan_period=0.05, task_deadline=60.0,
                                       **NO_STRAG)
        return _outcome(exec_pkg, _cmd_graph(taskarray), policy, "procpool",
                        **POOL)
    got = run(port_exec, port_taskarray)
    assert got == run(ref_exec, ref_taskarray)
    sq = got["arrays"]["sq"]
    assert sq["values"] == [x * x for x in range(6)]
    assert sq["tasks"][2][1:3] == ("ok", 2) and sq["summary"][3] == 1
    assert got["arrays"]["tot"]["values"] == [55]


def test_procpool_kill_launcher_recovers_and_reaps_everything():
    n = 8
    plan = port_exec.FaultPlan.seeded(123, n, n_launchers=2,
                                      workers_per_launcher=2,
                                      kinds=(port_exec.KILL_LAUNCHER,))
    g = port_taskarray.TaskGraph("chaos")
    g.map(cmd="time.sleep(0.25) or params['x'] * params['x']",
          params=[{"x": x} for x in range(n)], name="a")
    policy = port_taskarray.RetryPolicy(max_retries=3, backoff=0.05,
                                        scan_period=0.1, task_deadline=60.0,
                                        **NO_STRAG)
    with port_exec.get_backend("procpool", **POOL) as b:
        res = g.run(b, policy, chaos=plan)
        pool = b.pool
    assert res.all_ok
    assert res["a"].values == [x * x for x in range(n)]
    assert all(r.status == "ok" for r in res["a"].results)
    assert pool.crashes == 1
    assert res["a"].summary.lost >= 1
    counts = res.events.counts()
    assert counts.get(LOST, 0) == res["a"].summary.lost
    assert counts.get(FAULT, 0) >= 2    # the chaos kill + the pool's report
    stats = validate_trace(res.events, max_retries=3)
    assert stats.faults >= 2 and stats.lost >= 1
    assert len(pool._all_launchers) >= 2
    assert all(lp.poll() is not None for lp in pool._all_launchers)


@pytest.mark.parametrize("launch", [realproc.flat_launch,
                                    realproc.two_tier_launch])
def test_real_launch_completes_and_reaps(launch):
    r = launch(2, 2)
    assert r.total_procs == 4 and r.launch_time > 0
    assert r.strategy == ("flat" if launch is realproc.flat_launch
                          else "two-tier")
    assert r.procs and all(pr.poll() is not None for pr in r.procs)


def test_no_zombies_after_compare():
    flat, twot = realproc.compare(2, 4)
    assert (flat.strategy, twot.strategy) == ("flat", "two-tier")
    assert flat.total_procs == twot.total_procs == 8
    for result in (flat, twot):
        assert result.procs, result.strategy
        assert all(pr.poll() is not None for pr in result.procs)


def test_procpool_launch_report():
    with port_exec.get_backend("procpool", **POOL) as b:
        rep = b.launch(LaunchPlan(2, 2))
        assert b.pool is None             # a one-shot launch spawns no pool
    assert isinstance(rep, LaunchReport)
    assert rep.total_procs == 4 and rep.launch_time >= 0.0
    validate_trace(rep.events)


def test_kernel_build_reaps_its_compilers_when_a_spawn_fails(monkeypatch):
    """``_run_all`` starts every compiler before it waits for any: when a
    later spawn raises, the children already running are killed and
    reaped before the error propagates."""
    spawned = []

    class Recorded(subprocess.Popen):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            spawned.append(self)

    monkeypatch.setattr(build.subprocess, "Popen", Recorded)
    with pytest.raises(OSError):
        build._run_all([["sleep", "30"], ["/nonexistent-nvcc"]])
    [sleeper] = spawned
    assert sleeper.returncode is not None and sleeper.poll() is not None
    assert build._run_all([["sh", "-c", "echo built"],
                           ["sh", "-c", "exit 3"]]) == [(0, "built\n"),
                                                        (3, "")]

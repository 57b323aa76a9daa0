# The port's copy of repro/core/realproc.py: only the package prefix
# of its imports differs.
"""Real-process two-tier launch harness (methodology check, §III/§IV).

DEPRECATION SHIM: the actual machinery — the JSON-pipe WORKER/LAUNCHER
protocol, readiness waits with timeout, and try/finally teardown — lives
in repro.exec.pool (launch_once / WorkerPool), shared with the persistent
ProcPoolBackend so the two-tier topology is defined in exactly one place.
This module keeps the original public names for existing callers/tests:

  flat_launch      the "scheduler" (this process) forks every worker
                   itself: N_nodes * P sequential dispatch operations.
  two_tier_launch  the scheduler forks ONE launcher per simulated node;
                   each launcher spawns its P workers locally and reports
                   when all are running (paper T3).
  compare          both, for the ratio (which is load-independent).

Worker counts stay modest (hundreds, not 262k) — the point is the *ratio*
between topologies. New code should call
repro.exec.ProcPoolBackend().launch(LaunchPlan(...)) instead.
"""
from __future__ import annotations

import subprocess
from dataclasses import dataclass, field
from typing import List

from repro_torch.exec.pool import LAUNCHER_SRC as LAUNCHER  # noqa: F401
from repro_torch.exec.pool import WORKER_SRC as WORKER  # noqa: F401
from repro_torch.exec.pool import launch_once


@dataclass
class RealLaunchResult:
    """Legacy stats shape; prefer repro.exec.LaunchReport (`.report`)."""
    strategy: str
    n_nodes: int
    procs_per_node: int
    launch_time: float
    # the (already-waited) Popen handles, so callers/tests can verify
    # cleanup: every pr.poll() must be non-None (no zombies left behind)
    procs: List[subprocess.Popen] = field(default_factory=list, repr=False)
    report: object = field(default=None, repr=False)   # LaunchReport

    @property
    def total_procs(self) -> int:
        return self.n_nodes * self.procs_per_node

    @property
    def launch_rate(self) -> float:
        return self.total_procs / max(self.launch_time, 1e-9)


def _launch(topology: str, n_nodes: int, procs_per_node: int
            ) -> RealLaunchResult:
    report, procs = launch_once(n_nodes, procs_per_node, topology=topology)
    return RealLaunchResult(topology, n_nodes, procs_per_node,
                            report.launch_time, procs, report)


def flat_launch(n_nodes: int, procs_per_node: int) -> RealLaunchResult:
    """Central loop forks every worker (the naive topology)."""
    return _launch("flat", n_nodes, procs_per_node)


def two_tier_launch(n_nodes: int, procs_per_node: int) -> RealLaunchResult:
    """One launcher per node; launchers spawn their workers in parallel."""
    return _launch("two-tier", n_nodes, procs_per_node)


def compare(n_nodes: int = 8, procs_per_node: int = 16
            ) -> List[RealLaunchResult]:
    return [flat_launch(n_nodes, procs_per_node),
            two_tier_launch(n_nodes, procs_per_node)]

# The port's copy of repro/core/launcher.py: only the package prefix
# of its imports differs.
"""Launch strategies (paper §III): how N_nodes x P_proc processes start.

Three strategies, matching the paper's experimental progression:

  FlatSchedulerLaunch   every process is a scheduler-dispatched task
                        (job-array / naive srun): N*P dispatch operations
                        through the scheduler's dispatch loop.
  HierarchicalSshTree   the §III baseline: salloc a block, then spawn via an
                        ssh fan-out tree (branching ssh_fanout) — "how fast
                        launches could be enabled".
  TwoTierLauncher       the paper's contribution (T3): ONE scheduler-issued
                        launcher per node; the launcher locally spawns and
                        backgrounds P application processes.

All strategies share the application-start model: local exec contention +
local-disk reads (prepositioned) or central-Lustre reads (cold), through the
shared Lustre Resource — which produces the Fig-6/7 backpressure hockey
stick and the 30-60-minute naive launch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from .apps import AppProfile
from .cluster import Cluster, Node


@dataclass
class LaunchResult:
    strategy: str
    app: str
    n_nodes: int
    procs_per_node: int
    prepositioned: bool
    t_submit: float
    t_all_running: float       # last process entered "running"
    per_node_done: List[float]

    @property
    def launch_time(self) -> float:
        return self.t_all_running - self.t_submit

    @property
    def total_procs(self) -> int:
        return self.n_nodes * self.procs_per_node

    @property
    def launch_rate(self) -> float:
        return self.total_procs / max(self.launch_time, 1e-9)


def _app_start_done(cluster: Cluster, node: Node, app: AppProfile,
                    nproc: int, t_spawned: float) -> float:
    """Completion time for nproc app inits on `node` starting at t_spawned."""
    prep = app.name in node.prepositioned
    # local exec/init contention
    t_cpu = node.exec_contention(nproc, app.cpu_start)
    # local-disk dependency reads (only when prepositioned)
    if prep:
        t_disk = (nproc * app.files_local) / node.spec.local_read_rate
        files_central = app.files_central_warm
    else:
        t_disk = 0.0
        files_central = app.files_central_cold
    # central-FS reads go through the SHARED lustre resource (backpressure)
    done_central = cluster.lustre.request(nproc * files_central)
    return max(t_spawned + t_cpu + t_disk, done_central)


class FlatSchedulerLaunch:
    """Every process dispatched individually by the scheduler."""
    name = "flat"

    def launch(self, cluster: Cluster, nodes: List[Node], procs_per_node: int,
               app: AppProfile) -> LaunchResult:
        sim = cluster.sim
        t0 = sim.now
        per_node_done = []
        for nd in nodes:
            # N*P dispatch operations through the shared dispatch loop
            t_dispatched = cluster.sched_dispatch.request(procs_per_node)
            done = _app_start_done(cluster, nd, app, procs_per_node,
                                   t_dispatched)
            per_node_done.append(done)
        t_all = max(per_node_done)
        return LaunchResult(self.name, app.name, len(nodes), procs_per_node,
                            app.name in nodes[0].prepositioned, t0, t_all,
                            per_node_done)


class HierarchicalSshTree:
    """salloc + ssh fan-out tree (the paper's baseline experiment)."""
    name = "ssh-tree"

    def launch(self, cluster: Cluster, nodes: List[Node], procs_per_node: int,
               app: AppProfile) -> LaunchResult:
        sim = cluster.sim
        t0 = sim.now
        spec = cluster.spec
        depth = max(1, math.ceil(math.log(max(len(nodes), 2), spec.ssh_fanout)))
        t_tree = depth * spec.ssh_latency
        per_node_done = []
        for nd in nodes:
            # each node backgrounds its P procs locally once the tree
            # reaches it; nodes spawn in parallel, so the per-node spawner
            # is charged directly (no Resource booking — each launch is the
            # node's only spawn, and double-booking the Resource on top of
            # this term was overstating occupancy)
            t_spawned = t0 + t_tree + procs_per_node / nd.spec.fork_rate
            done = _app_start_done(cluster, nd, app, procs_per_node,
                                   t_spawned)
            per_node_done.append(done)
        t_all = max(per_node_done)
        return LaunchResult(self.name, app.name, len(nodes), procs_per_node,
                            app.name in nodes[0].prepositioned, t0, t_all,
                            per_node_done)


class TwoTierLauncher:
    """Paper T3: scheduler dispatches ONE launcher per node; launchers spawn
    and background the P application processes locally, in parallel across
    nodes."""
    name = "two-tier"

    def launch(self, cluster: Cluster, nodes: List[Node], procs_per_node: int,
               app: AppProfile) -> LaunchResult:
        sim = cluster.sim
        t0 = sim.now
        per_node_done = []
        for nd in nodes:
            # one dispatch op per NODE (this is the whole trick)
            t_launcher = cluster.sched_dispatch.request(1)
            # local backgrounding of P procs
            t_spawned = t_launcher + procs_per_node / nd.spec.fork_rate
            done = _app_start_done(cluster, nd, app, procs_per_node,
                                   t_spawned)
            per_node_done.append(done)
        t_all = max(per_node_done)
        return LaunchResult(self.name, app.name, len(nodes), procs_per_node,
                            app.name in nodes[0].prepositioned, t0, t_all,
                            per_node_done)


STRATEGIES = {c.name: c for c in (FlatSchedulerLaunch, HierarchicalSshTree,
                                  TwoTierLauncher)}

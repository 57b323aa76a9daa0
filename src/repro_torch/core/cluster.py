# The port's copy of repro/core/cluster.py: only the package prefix
# of its imports differs.
"""Cluster model: TX-Green (648 x Xeon Phi 7210) + timing constants.

Constants are engineering estimates calibrated against the paper's own
measurements (§IV): 32k TensorFlow < 5 s, 32k Octave < 10 s, 262k Octave
< 40 s, ~6000 launches/s sustained, naive 40k-core MATLAB launch 30-60 min.
EXPERIMENTS.md tabulates simulated vs claimed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .events import Resource, Sim


@dataclass(frozen=True)
class NodeSpec:
    cores: int = 64
    hyperthreads: int = 4           # Xeon Phi 7210: 4 HT/core
    ram_gb: int = 192
    local_disk: bool = True
    # local process machinery
    fork_rate: float = 500.0        # background-spawn rate of the launcher
    local_read_rate: float = 20000.0  # local-disk file reads/s (per node)


@dataclass(frozen=True)
class ClusterSpec:
    n_nodes: int = 648
    node: NodeSpec = field(default_factory=NodeSpec)
    # scheduler machinery (Slurm-like)
    sched_dispatch_rate: float = 500.0   # scheduler-issued task starts/s
    sched_rpc_latency: float = 0.05      # per dispatch RPC
    sched_eval_period: float = 0.5       # queue evaluation periodicity (§III)
    sched_eval_depth: int = 1024         # queue evaluation depth (§III)
    # ssh machinery (baseline §III experiment)
    ssh_latency: float = 0.15            # per ssh hop
    ssh_fanout: int = 16
    # central storage (Lustre / ClusterStor CS9000)
    lustre_rate: float = 18000.0         # file requests/s sustained
    lustre_latency: float = 0.002
    # batch queue (Figure 1): synthetic backlog wait when batch-scheduled
    batch_wait_mean: float = 1800.0

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.node.cores     # 41,472 on TX-Green

    def slots_per_node(self) -> int:
        return self.node.cores * self.node.hyperthreads


TX_GREEN = ClusterSpec()


class Node:
    """Simulated compute node: occupancy + local spawn/read resources."""

    def __init__(self, sim: Sim, spec: NodeSpec, node_id: int):
        self.sim = sim
        self.spec = spec
        self.id = node_id
        self.free_cores = spec.cores
        self.alive = True
        self.prepositioned: Set[str] = set()
        self.spawner = Resource(sim, spec.fork_rate)
        self.disk = Resource(sim, spec.local_read_rate)

    def exec_contention(self, nproc: int, cpu_start: float) -> float:
        """Wall time for nproc simultaneous app inits on this node."""
        contexts = self.spec.cores * min(self.spec.hyperthreads, 2)
        waves = max(1, -(-nproc // contexts))       # ceil
        return cpu_start * waves


class Cluster:
    def __init__(self, sim: Sim, spec: ClusterSpec = TX_GREEN):
        self.sim = sim
        self.spec = spec
        self.nodes: List[Node] = [Node(sim, spec.node, i)
                                  for i in range(spec.n_nodes)]
        self.lustre = Resource(sim, spec.lustre_rate, spec.lustre_latency)
        self.sched_dispatch = Resource(sim, spec.sched_dispatch_rate,
                                       spec.sched_rpc_latency)

    # ---- allocation -------------------------------------------------------
    def alloc_nodes(self, n: int, whole: bool = True) -> Optional[List[Node]]:
        free = [nd for nd in self.nodes if nd.alive and
                nd.free_cores == nd.spec.cores]
        if len(free) < n:
            return None
        got = free[:n]
        for nd in got:
            nd.free_cores = 0
        return got

    def alloc_cores(self, n_cores: int) -> Optional[Dict[Node, int]]:
        alloc: Dict[Node, int] = {}
        need = n_cores
        for nd in self.nodes:
            if not nd.alive or nd.free_cores == 0:
                continue
            take = min(nd.free_cores, need)
            alloc[nd] = take
            need -= take
            if need == 0:
                break
        if need > 0:
            return None
        for nd, take in alloc.items():
            nd.free_cores -= take
        return alloc

    def release(self, alloc) -> None:
        if isinstance(alloc, dict):
            for nd, take in alloc.items():
                nd.free_cores = min(nd.spec.cores, nd.free_cores + take)
        else:
            for nd in alloc:
                nd.free_cores = nd.spec.cores

    # ---- failures (fault injection) ----------------------------------------
    def kill_node(self, node_id: int):
        self.nodes[node_id].alive = False

    def revive_node(self, node_id: int):
        nd = self.nodes[node_id]
        nd.alive = True
        nd.free_cores = nd.spec.cores

    def outage(self, node_id: int, duration: float) -> None:
        """Node-outage/recovery model (exec.chaos KILL_LAUNCHER on the sim
        backend): the node dies NOW and revives `duration` simulated
        seconds later. While down it is excluded from every allocation —
        retries and new arrays run on reduced capacity, exactly like a
        respawning launcher slot in the real WorkerPool."""
        self.kill_node(node_id)
        self.sim.schedule(duration, lambda: self.revive_node(node_id))

    # ---- prepositioning (paper T4) -----------------------------------------
    def preposition(self, app_name: str, nodes: Optional[List[Node]] = None):
        for nd in (nodes or self.nodes):
            nd.prepositioned.add(app_name)

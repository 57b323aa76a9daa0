"""The paper's primary contribution, interactive launch, in the port.

The discrete-event reproduction of TX-Green (events, cluster, apps,
launcher, scheduler: copies of the reference's modules), the launch on
CUDA cards (preposition: warm member steps and prepositioned weights;
supervisor: the chip quota and one task array per sweep), and the check
with real OS processes (realproc, a deprecation shim over
``repro_torch.exec.pool``, imported by name and not re-exported here).
"""
from .apps import PROFILES, AppProfile
from .cluster import TX_GREEN, Cluster, ClusterSpec, Node, NodeSpec
from .events import Resource, Sim, Timer
from .launcher import (STRATEGIES, FlatSchedulerLaunch, HierarchicalSshTree,
                       LaunchResult, TwoTierLauncher)
from .preposition import (CompileCacheWarmer, WarmEntry, WeightPrepositioner,
                          cache_key)
from .scheduler import (AdmissionMode, ArrayJob, Job, JobState, Scheduler,
                        SchedulerStats, UserLimits, measure_launch)
from .supervisor import (ChipQuota, SweepMember, SweepSupervisor,
                         carve_devices)

__all__ = [
    "PROFILES", "AppProfile", "TX_GREEN", "Cluster", "ClusterSpec", "Node",
    "NodeSpec", "Resource", "Sim", "Timer", "STRATEGIES",
    "FlatSchedulerLaunch", "HierarchicalSshTree", "LaunchResult",
    "TwoTierLauncher", "CompileCacheWarmer", "WarmEntry",
    "WeightPrepositioner", "cache_key", "AdmissionMode", "ArrayJob", "Job",
    "JobState", "Scheduler", "SchedulerStats", "UserLimits",
    "measure_launch", "ChipQuota", "SweepMember", "SweepSupervisor",
    "carve_devices",
]

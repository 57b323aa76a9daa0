"""The paper's interactive launch on CUDA cards: prepositioning (warm member
steps, prepositioned weights) and the sweep supervisor (chip quota, one task
array per sweep). The port's counterpart of the TPU adaptation in
``repro.core``; the reference's discrete-event reproduction (events,
cluster, apps, launcher, scheduler) and its real-process check (realproc)
are not ported.
"""
from .preposition import (CompileCacheWarmer, WarmEntry, WeightPrepositioner,
                          cache_key)
from .supervisor import (ChipQuota, SweepMember, SweepSupervisor,
                         carve_devices)

__all__ = [
    "CompileCacheWarmer", "WarmEntry", "WeightPrepositioner", "cache_key",
    "ChipQuota", "SweepMember", "SweepSupervisor", "carve_devices",
]

"""Interactive sweep supervisor — the paper's workflow on CUDA cards; the
port's counterpart of ``repro.core.supervisor``.

The LLSC workflow is "one analyst, hundreds of models, seconds to launch".
On a GPU host the resources are cards; the supervisor

  * carves the session's cards into equal **device groups** and hands each
    sweep member its own (the analogue of whole-node allocation),
  * enforces per-session **chip quotas** (paper T1: user resource limits,
    the safe point in the Fig-2 quadrant). Chips are held for the
    MEMBER'S LIFETIME — acquired at launch, returned by `release()` (or
    on a failed launch) — so concurrent members genuinely contend, and
    members held at admission can be launched later via `retry_held()`,
  * launches members through the prepositioned warm cache (paper T4), so
    the interactive loop contains no kernel build and no first-call cost,
  * dispatches through the execution layer (repro_torch.exec): each
    launch_sweep call submits ONE task array to an ExecBackend
    (InlineBackend by default), so members get the gather summaries and
    structured event stream of every other launch route,
  * reports *launch time to first step* per member — exactly what Fig. 4
    reports as process-launch time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.exec.base import COMPLETE, SUBMIT, EventLog
from .preposition import CompileCacheWarmer, WeightPrepositioner


@dataclass
class ChipQuota:
    max_chips: int
    held: int = 0

    def try_acquire(self, n: int) -> bool:
        if self.held + n > self.max_chips:
            return False
        self.held += n
        return True

    def release(self, n: int):
        self.held = max(0, self.held - n)


@dataclass
class SweepMember:
    mid: int
    hparams: Dict[str, Any]
    submitted_at: float = 0.0
    launched_at: Optional[float] = None   # first step DONE
    state: str = "pending"     # pending -> held | running -> finished/failed
    result: Any = None
    chips: int = 0                        # chips held while running
    _ctx: Optional[Tuple] = field(default=None, repr=False)  # retry_held

    @property
    def launch_time(self) -> Optional[float]:
        if self.launched_at is None:
            return None
        return self.launched_at - self.submitted_at


def carve_devices(devices: Sequence, n: int) -> List[Tuple]:
    """Split a device list into n equal groups, in order (the counterpart
    of ``carve_submeshes``: whole-card allocation)."""
    devices = tuple(devices)
    assert len(devices) % n == 0, (len(devices), n)
    size = len(devices) // n
    return [devices[i * size:(i + 1) * size] for i in range(n)]


class SweepSupervisor:
    """Admission + dispatch for interactive sweeps on one host's cards.

    Admission (quota) is the supervisor's job; dispatch goes through an
    ExecBackend (repro_torch.exec), mirroring the scheduler's JobLifecycle /
    JobExecution split in Figure 3. With no ``devices`` it takes every CUDA
    card and raises when there is none; it never picks the CPU by itself.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 max_chips: Optional[int] = None, backend=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SweepSupervisor: no CUDA card is available (pass "
                    "devices=[torch.device('cpu')] to run on the CPU)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(torch.device(d) for d in devices)
        self.quota = ChipQuota(len(self.devices) if max_chips is None
                               else max_chips)
        self.warmer = CompileCacheWarmer()
        self.weights = WeightPrepositioner()
        self.members: List[SweepMember] = []
        self.events = EventLog()          # unified submit/dispatch stream
        self._backend = backend           # default: InlineBackend (lazy)
        self._sweeps = 0

    @property
    def backend(self):
        if self._backend is None:
            from repro_torch.exec.inline import InlineBackend
            self._backend = InlineBackend(sleep=False)
        return self._backend

    # -- prepositioning (slow path, before the session) ---------------------
    def preposition(self, cfg: ArchConfig, shape: ShapeConfig,
                    devices: Sequence, build: Callable[[], Any],
                    init: Optional[Callable[[], Any]] = None, seed: int = 0):
        # the weights first: the warm step then grows the caching
        # allocator's pool beside them, to a member's whole footprint
        if init is not None:
            self.weights.preposition(cfg, devices, seed, init)
        return self.warmer.warm(cfg, shape, devices, build)

    # -- interactive fast path ----------------------------------------------
    def launch_sweep(self, cfg: ArchConfig, shape: ShapeConfig,
                     devices: Sequence, grid: Sequence[Dict[str, Any]],
                     run_member: Callable[[Any, SweepMember], Any],
                     seed: int = 0) -> List[SweepMember]:
        """Launch one member per hparam dict through the warm cache.

        run_member(warm_entry, member) performs the member's first step
        (and any bookkeeping); launch time = submit -> first step done.

        Members that clear the chip quota run as ONE task array on the
        exec backend and end up "running" — still holding their chips
        until release(). Members over quota end up "held"; call
        retry_held() after releasing capacity to launch them.
        """
        n_chips = len(devices)
        out: List[SweepMember] = []
        admitted: List[SweepMember] = []
        for hp in grid:
            m = SweepMember(len(self.members), dict(hp),
                            submitted_at=time.monotonic())
            m._ctx = (cfg, shape, devices, run_member, n_chips)
            self.members.append(m)
            out.append(m)
            self.events.emit(SUBMIT, m.submitted_at, task=m.mid,
                             detail={"chips": n_chips})
            if not self.quota.try_acquire(n_chips):
                m.state = "held"            # over quota: stays pending
                continue
            m.chips = n_chips
            admitted.append(m)
        if admitted:
            self._dispatch(admitted)
        return out

    def retry_held(self) -> List[SweepMember]:
        """Admission pass over held members: launch every held member the
        quota now admits; returns the ones launched."""
        admitted: List[SweepMember] = []
        for m in self.members:
            if m.state != "held":
                continue
            cfg, shape, devices, run_member, n_chips = m._ctx
            if not self.quota.try_acquire(n_chips):
                continue
            m.chips = n_chips
            m.state = "pending"
            admitted.append(m)
        if admitted:
            self._dispatch(admitted)
        return admitted

    def release(self, member: SweepMember) -> None:
        """End of the member's lifetime: return its chips. Idempotent."""
        if member.state == "running":
            member.state = "finished"
        if member.chips:
            self.quota.release(member.chips)
            member.chips = 0

    # -- dispatch through the exec protocol ---------------------------------
    def _dispatch(self, admitted: List[SweepMember]) -> None:
        """Submit the admitted members as one task array on the backend;
        the gather layer gives per-member status and an array summary for
        free (and its event stream lands in result.events)."""
        from repro_torch.taskarray import RetryPolicy, TaskGraph

        def member_task(params, inputs):
            m: SweepMember = params["member"]
            cfg, shape, devices, run_member, _ = m._ctx
            entry = self.warmer.get(cfg, shape, devices)   # NEVER builds
            m.result = run_member(entry, m)
            m.launched_at = time.monotonic()
            m.state = "running"
            return m.result

        self._sweeps += 1
        g = TaskGraph(f"sweep{self._sweeps}")
        g.map(member_task, [{"member": m} for m in admitted],
              name=f"sweep{self._sweeps}")
        res = self.backend.run_graph(g, RetryPolicy(max_retries=0))
        arr = res[f"sweep{self._sweeps}"]
        for m, r in zip(admitted, arr.results):
            if r.status != "ok":            # launch failed: chips come back
                m.state = "failed"
                m.result = r.error
                self.quota.release(m.chips)
                m.chips = 0
            self.events.emit(COMPLETE, r.finished_at or time.monotonic(),
                             task=m.mid, ok=r.status == "ok")

    def launch_report(self) -> Dict[str, float]:
        times = [m.launch_time for m in self.members
                 if m.launch_time is not None]
        if not times:
            return {"n": 0}
        return {"n": len(times),
                "total_s": sum(times),
                "mean_s": float(np.mean(times)),
                "max_s": float(np.max(times)),
                "rate_per_s": len(times) / max(sum(times), 1e-9)}

"""Fault-tolerant training loop of the port (counterpart of
``repro/train/trainer.py``).

The reference's behaviours, on one device:
  * periodic async checkpointing (``CheckpointManager``)
  * resume from the latest checkpoint on construction
  * preemption handling: SIGTERM/SIGINT trigger checkpoint-then-exit
  * step retry with bounded backoff on transient failures; when the
    retries run out it checkpoints and raises
  * deterministic data by step index, so no data is lost or repeated
    across restarts.

Differences by design: the mesh argument is dropped (one device), and the
constructor takes ``device`` (the card unless the caller asks for the CPU;
without a card it raises). A retry re-runs the same step on the same
device with the same kernels; it never falls back to the plain versions or
to the CPU. The step updates params and moments in place once every
gradient is computed, where JAX donates them to the step, so a failure
before the update leaves the state a retry starts from as it was.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

from repro_torch.ckpt import CheckpointManager, latest_step, restore
from repro_torch.train.step import (init_train_state, make_train_step,
                                    resolve_device, to_batch)


@dataclass
class TrainerConfig:
    # the reference's /tmp/repro_ckpt, under the process's TMPDIR
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    log_every: int = 10


class Trainer:
    def __init__(self, cfg, batch_fn: Callable, tc: TrainerConfig,
                 device="cuda", log: Callable[[str], None] = print):
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.batch_fn = batch_fn
        self.log = log
        self.mgr = CheckpointManager(tc.ckpt_dir, keep=tc.keep)
        self._preempted = False
        self.step_fn = make_train_step(
            cfg, peak_lr=tc.peak_lr, warmup=tc.warmup,
            total_steps=tc.total_steps, device=self.device)

        # ---- init or resume ------------------------------------------------
        self.params, self.opt_state = init_train_state(cfg,
                                                       device=self.device)
        self.step = 0
        last = latest_step(tc.ckpt_dir)
        if last is not None:
            self._restore(last)

    # ------------------------------------------------------------------
    def _restore(self, step: int):
        state = {"params": self.params, "opt": self.opt_state}
        restored, manifest = restore(self.tc.ckpt_dir, state, step=step,
                                     device=self.device)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.step = manifest["step"]
        self.log(f"[trainer] resumed from step {self.step} "
                 f"(device {self.device})")

    def _checkpoint(self, blocking=False):
        state = {"params": self.params, "opt": self.opt_state}
        self.mgr.save_async(self.step, state, meta={"arch": self.cfg.name})
        if blocking:
            self.mgr.wait()

    def _on_preempt(self, signum, frame):
        self._preempted = True

    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, Any]:
        old1 = signal.signal(signal.SIGTERM, self._on_preempt)
        old2 = signal.signal(signal.SIGINT, self._on_preempt)
        losses = []
        t0 = time.monotonic()
        try:
            end = self.step + num_steps
            while self.step < end and not self._preempted:
                batch = to_batch(self.batch_fn(self.step), self.device)
                for attempt in range(self.tc.max_retries + 1):
                    try:
                        self.params, self.opt_state, metrics = self.step_fn(
                            self.params, self.opt_state, batch, self.step)
                        break
                    except Exception as e:     # transient failure -> retry
                        if attempt == self.tc.max_retries:
                            self._checkpoint(blocking=True)
                            raise
                        self.log(f"[trainer] step {self.step} failed "
                                 f"({type(e).__name__}); retry {attempt+1}")
                        time.sleep(0.1 * 2 ** attempt)
                self.step += 1
                loss = float(metrics["loss"])
                losses.append(loss)
                if self.step % self.tc.log_every == 0:
                    dt = time.monotonic() - t0
                    self.log(f"[trainer] step {self.step} loss {loss:.4f} "
                             f"({dt:.1f}s)")
                if self.step % self.tc.ckpt_every == 0:
                    self._checkpoint()
            if self._preempted:
                self.log("[trainer] preemption signal — checkpointing")
                self._checkpoint(blocking=True)
        finally:
            signal.signal(signal.SIGTERM, old1)
            signal.signal(signal.SIGINT, old2)
            self.mgr.wait()
        return {"losses": losses, "step": self.step,
                "preempted": self._preempted}

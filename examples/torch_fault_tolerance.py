"""Fault tolerance on the PyTorch port: preemption, restart, node failure,
stragglers.

    PYTHONPATH=src python examples/torch_fault_tolerance.py [--device cuda]

Three layers of the story:
 1. SCHEDULER level (the paper's cluster, simulated): a node dies mid-job ->
    the job is requeued and placed off the dead node; a straggler is
    detected and re-dispatched.
 2. EXEC level (repro_torch.exec chaos): a FaultPlan SIGKILLs one of two
    real pool launchers mid-array -> the pool reports the lost in-flight
    attempts into the driver's fail-fast retry path, respawns the slot, and
    the run completes with zero failed tasks.
 3. TRAINER level (the payload, on ``--device``): SIGTERM triggers
    checkpoint-then-exit; a new Trainer resumes from the checkpoint and the
    losses equal the uninterrupted run's bit for bit (the data is
    deterministic by step index, the params drawn from a seeded generator).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.core.cluster import Cluster, ClusterSpec
from repro_torch.core.events import Sim
from repro_torch.core.scheduler import JobState, Scheduler
from repro_torch.data import SyntheticLM
from repro_torch.exec import (FAULT, KILL_LAUNCHER, LOST, Fault, FaultPlan,
                              get_backend)
from repro_torch.taskarray import RetryPolicy, TaskGraph
from repro_torch.train import Trainer, TrainerConfig


def scheduler_level():
    print("== scheduler level (simulated TX-Green) ==")
    sim = Sim()
    cluster = Cluster(sim, ClusterSpec(n_nodes=8))
    cluster.preposition("octave")
    events = []
    sched = Scheduler(sim, cluster, straggler_factor=3.0,
                      on_event=lambda kind, job: events.append(
                          (round(sim.now, 2), kind, job.jid)))
    job = sched.submit("analyst", "octave", 4, 64, work_seconds=60.0)
    sched.run(until=10.0)
    dead = job.nodes[0].id
    print(f"t=10s: node {dead} dies while job {job.jid} is RUNNING")
    sched.fail_node(dead)
    sched.run()
    assert job.state == JobState.COMPLETED
    assert dead not in [nd.id for nd in job.nodes]
    print(f"job requeued {job.requeues}x, straggler re-dispatches "
          f"{job.straggler_redispatches}, completed at t={job.finished_at:.1f}s "
          f"on nodes {[nd.id for nd in job.nodes]} (node {dead} avoided)")
    print("events:", events)
    return job, events


def exec_level(n: int = 8):
    print("\n== exec level (real processes, chaos SIGKILL) ==")
    plan = FaultPlan((Fault(KILL_LAUNCHER, launcher=0, after=1),),
                     n_launchers=2, workers_per_launcher=2)
    g = TaskGraph("chaos-demo")
    g.map(cmd="time.sleep(0.2) or params['x'] * params['x']",
          params=[{"x": x} for x in range(n)], name="sq")
    with get_backend("procpool", n_launchers=2,
                     workers_per_launcher=2) as b:
        t0 = time.monotonic()
        res = g.run(b, RetryPolicy(max_retries=3, backoff=0.05,
                                   scan_period=0.1, task_deadline=60.0),
                    chaos=plan)
        elapsed = time.monotonic() - t0
        respawns = b.pool.respawns
    assert res.all_ok and res["sq"].values == [x * x for x in range(n)]
    assert res["sq"].summary.failed == 0
    counts = res.events.counts()
    print(f"launcher 0 SIGKILLed after 1 completion: "
          f"{counts.get(LOST, 0)} in-flight attempts reported lost, "
          f"{counts.get(FAULT, 0)} fault events, pool respawns={respawns}")
    print(f"array still completed all {n} tasks OK in {elapsed:.1f}s "
          f"(fail-fast recovery, not the 60s task_deadline)")
    print(str(res["sq"].summary))
    return res, respawns


def trainer_level(device, steps: int = 16, preempt_at: int = 8):
    print("\n== trainer level (payload checkpoint/restart) ==")
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").reduced(),
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, block_pattern=(), remat="none",
        param_dtype="float32")
    src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    quiet = lambda s: None

    with tempfile.TemporaryDirectory() as d:
        ref_dir, ckpt_dir = os.path.join(d, "ref"), os.path.join(d, "ckpt")
        # uninterrupted reference
        ref = Trainer(cfg, src.batch,
                      TrainerConfig(ckpt_dir=ref_dir, ckpt_every=10**6,
                                    log_every=10**6),
                      device=device, log=quiet).run(steps)["losses"]

        # preempted run: SIGTERM during step `preempt_at`
        tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4, log_every=10**6)
        tr1 = Trainer(cfg, src.batch, tc, device=device, log=print)
        orig, calls = tr1.step_fn, [0]

        def signal_at(*a, **kw):
            calls[0] += 1
            if calls[0] == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(*a, **kw)

        tr1.step_fn = signal_at
        out1 = tr1.run(steps)
        assert out1["preempted"] and out1["step"] < steps, out1
        print(f"preempted at step {out1['step']} (checkpoint written)")

        # restart resumes and repeats the reference trajectory bit for bit
        tr2 = Trainer(cfg, src.batch, tc, device=device, log=print)
        out2 = tr2.run(steps - out1["step"])
    merged = out1["losses"] + out2["losses"]
    assert merged == ref, (merged, ref)
    print(f"restart from step {out1['step']}: the {len(merged)} losses equal "
          f"the uninterrupted run's bit for bit (no data lost, none "
          f"repeated)")
    return out1, out2, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"scheduler": scheduler_level(), "exec": exec_level(),
           "trainer": trainer_level(args.device)}
    print("\nfault-tolerance demo OK")
    return out


if __name__ == "__main__":
    main()

"""The paper's scenario on the PyTorch port: an interactive hyperparameter
sweep with a prepositioned member step and weights.

    PYTHONPATH=src python examples/torch_interactive_sweep.py [--members 16] \
        [--steps 5] [--device cuda]

The analyst workflow of the paper's §IV, "launch hundreds of machine
learning models in a matter of seconds". On a card the artefact between
"user hits enter" and "first step executes" is the kernels' library and the
first step's one-off costs (CUDA context, cuBLAS handles, the allocator's
pools); the SweepSupervisor prepositions them and the base weights (paper
T4), enforces chip quotas (T1), and the interactive loop then launches
every member through the warm cache with no build in it. Members share one
member step; each member's learning rate is an argument of it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.supervisor import SweepSupervisor
from repro_torch.data import SyntheticLM
from repro_torch.launch.sweep import (build_member_step, member_config,
                                      member_runner)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.train.step import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-chips", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = member_config("qwen3-0.6b")
    dev = resolve_device(args.device)
    devices = (dev,)
    shape = SHAPES["train_4k"]
    sup = SweepSupervisor(devices=devices, max_chips=args.max_chips)
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    grid = [{"lr": float(lr)}
            for lr in np.geomspace(1e-4, 3e-2, args.members)]

    def seeded_params():
        return init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)

    def build():
        def make_args():               # throwaway inputs of the member's shapes
            params = seeded_params()
            return params, adamw_init(params), src.batch(0), grid[0]["lr"]
        return build_member_step(cfg, device=dev), make_args

    # ---- slow path: preposition BEFORE the interactive session -------------
    t0 = time.monotonic()
    sup.preposition(cfg, shape, devices, build, init=seeded_params)
    print(f"prepositioned the kernels, the first step's costs and the "
          f"weights in {time.monotonic() - t0:.2f}s")
    warmed = dict(sup.warmer.stats)

    # ---- interactive fast path ---------------------------------------------
    run_member = member_runner(sup.weights.get(cfg, devices, 0), args.steps,
                               src)
    t0 = time.monotonic()
    members = sup.launch_sweep(cfg, shape, devices, grid, run_member)
    # chips are held for each member's lifetime; run_member finished the
    # member's steps, so release and admit the held backlog (quota
    # contention + retry_held: members launch in waves of quota capacity)
    waves = 1
    launched = [m for m in members if m.state == "running"]
    while launched:
        for m in launched:
            sup.release(m)
        launched = sup.retry_held()
        waves += bool(launched)
    dt = time.monotonic() - t0

    builds = sup.warmer.stats["warms"] - warmed["warms"]
    print(f"\nlaunched {len(members)} sweep members x {args.steps} steps in "
          f"{dt:.2f}s ({len(members) / dt:.1f} members/s, {waves} quota "
          f"wave(s)); builds in the loop: {builds} ({sup.warmer.stats})")
    best = min(members, key=lambda m: m.result)
    for m in members:
        mark = " <-- best" if m is best else ""
        print(f"  lr={m.hparams['lr']:.2e} final_loss={m.result:.4f} "
              f"launch={1e3 * m.launch_time:7.1f}ms{mark}")
    print(f"\nlaunch report: {sup.launch_report()}")
    assert builds == 0 and sup.warmer.stats["misses"] == 0, sup.warmer.stats
    assert all(m.state == "finished" for m in members)
    return sup, members


if __name__ == "__main__":
    main()

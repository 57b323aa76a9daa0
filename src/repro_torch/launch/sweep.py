"""The end-to-end "interactive supercomputing" driver of the port (the
paper as a CLI; counterpart of ``repro/launch/sweep.py``, same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.sweep --arch qwen3-0.6b \
        --members 16 --steps 5 [--device cpu]

Workflow:
  1. PREPOSITION (slow path, before the analyst is waiting): load the
     kernels' library and run one member step on throwaway inputs
     (``core.preposition``), and materialize the base weights on the card.
  2. INTERACTIVE LAUNCH: submit the sweep as ONE ``repro_torch.taskarray``
     job array whose tasks each launch a member through the warm cache
     under a chip quota (``core.supervisor``); the gather layer reports
     per-member status and the launch rate, the way Fig. 4 reports
     process-launch times.

A member is the reduced config of an arch with ``n_layers=2``, fp32 params
and no remat, trained by ``member_step(params, opt, batch, lr)``:
``forward_loss`` -> gradients of every param leaf -> ``adamw_update``. The
``n_layers=2`` does not shorten the model: ``reduced()`` fixes
``block_pattern`` at the reduced layer count (4 for qwen3) and the pattern
decides the stages, in the JAX package and in its copy here alike.

The gradients come from autograd through the port's kernels: the flash
attention and RMSNorm ``autograd.Function``s launch the hand-written
backward kernels on the card. The optimizer updates in place, so each
member trains its own device-side clone of the prepositioned weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.supervisor import SweepSupervisor
from repro_torch.data import SyntheticLM
from repro_torch.exec import get_backend
from repro_torch.models import forward_loss, init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.taskarray import GraphResult, RetryPolicy, TaskGraph


def member_config(arch: str = "qwen3-0.6b"):
    """The sweep member's config: ``repro/launch/sweep.py:66-68``."""
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2,
                               param_dtype="float32", remat="none")


def loss_and_grads(params, cfg, batch):
    """(loss, grads): ``forward_loss`` and its gradient with respect to every
    param leaf, in the params' tree. It differentiates detached aliases of
    the leaves (the same storage), so the caller's params stay as they were:
    none requires grad, and serving them afterwards records no graph."""
    alias = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = forward_loss(alias, cfg, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(alias)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def to_batch(batch, device):
    """numpy batch (``SyntheticLM``) -> int64 tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}


def build_member_step(cfg, device="cuda"):
    """``member_step(params, opt, batch, lr) -> (params, opt, loss)`` on
    ``device`` (the card unless the caller asks for the CPU). ``batch`` is
    numpy or tensors; params and moments are updated in place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("member_step: device 'cuda' asked for but no CUDA "
                           "card is available (pass device='cpu')")

    def member_step(params, opt, batch, lr):
        loss, grads = loss_and_grads(params, cfg, to_batch(batch, device))
        params, opt, _ = adamw_update(grads, opt, params, lr=lr)
        return params, opt, loss

    return member_step


def member_runner(base_params, steps: int, src):
    """The sweep's ``run_member(entry, member)``: ``steps`` steps of the warm
    member step on ``src``'s batches at ``member.hparams["lr"]``, from the
    member's own clone of ``base_params`` (a copy on their device: the
    optimizer works in place); returns the last step's loss."""
    def run_member(entry, member):
        params = tree_map(torch.clone, base_params)
        opt = adamw_init(params)
        loss = None
        for step in range(steps):
            params, opt, loss = entry.step(params, opt, src.batch(step),
                                           member.hparams["lr"])
        return float(loss)
    return run_member


class SweepRun(NamedTuple):
    result: GraphResult          # the outer task array's gathered result
    supervisor: SweepSupervisor
    members: List[Any]           # {"lr", "loss", "launch_s"} per member
    preposition_s: float
    wall_s: float                # the task array, launch to gather


def run_sweep(cfg, members: int, steps: int, device="cuda", init=None,
              max_chips=None) -> SweepRun:
    """Preposition the member step and the base params on ``device`` (the
    card unless the caller asks for the CPU), then train ``members`` members
    of ``steps`` steps at learning rates ``np.geomspace(1e-4, 3e-2)`` as one
    task array, each member launched through the supervisor under its chip
    quota. ``init`` is the base params (default: ``init_params`` from seed
    0 on the device); each member trains its own clone of them."""
    dev = torch.device(device)
    sup = SweepSupervisor(devices=None if dev.type == "cuda" else [dev],
                          max_chips=max_chips)
    devices = sup.devices[:1] if dev.index is None else (dev,)
    shape = SHAPES["train_4k"]
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    grid = [{"lr": float(lr)} for lr in np.geomspace(1e-4, 3e-2, members)]

    def seeded_params():
        gen = torch.Generator(devices[0]).manual_seed(0)
        return init_params(cfg, gen, device=devices[0])

    def build():
        def make_args():               # throwaway: never the base params
            params = seeded_params()
            return params, adamw_init(params), src.batch(0), grid[0]["lr"]
        return build_member_step(cfg, device=devices[0]), make_args

    t0 = time.monotonic()
    sup.preposition(cfg, shape, devices, build,
                    init=seeded_params if init is None else lambda: init)
    preposition_s = time.monotonic() - t0
    base_params = sup.weights.get(cfg, devices, 0)

    run_member = member_runner(base_params, steps, src)

    # the sweep IS a task array: one task per member, submitted through
    # the exec backend layer (repro_torch.exec) and gathered with
    # per-task status/retries and an array-level launch summary
    def member_fn(params, inputs):
        [m] = sup.launch_sweep(cfg, shape, devices, [params], run_member)
        if m.state == "held":
            raise RuntimeError("held: over chip quota")
        sup.release(m)          # steps done -> member's lifetime ends
        return {"lr": params["lr"], "loss": m.result,
                "launch_s": m.launch_time}

    graph = TaskGraph("hparam-sweep")
    graph.map(member_fn, grid, name="sweep")
    t0 = time.monotonic()
    res = graph.run(get_backend("inline"), RetryPolicy(max_retries=0))
    wall_s = time.monotonic() - t0
    return SweepRun(res, sup, res["sweep"].values, preposition_s, wall_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-chips", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    run = run_sweep(member_config(args.arch), args.members, args.steps,
                    device=args.device, max_chips=args.max_chips)
    sup, arr, dt = run.supervisor, run.result["sweep"], run.wall_s
    print(f"prepositioned in {run.preposition_s:.2f}s")
    ran = [v for v in run.members if v is not None]
    best = min(ran, key=lambda v: v["loss"]) if ran else None
    warms = sup.warmer.stats["warms"]
    print(f"launched {len(ran)}/{arr.summary.n_tasks} members x "
          f"{args.steps} steps in {dt:.2f}s "
          f"({len(ran)/max(dt,1e-9):.1f}/s; {arr.summary.failed} held "
          f"by quota; warms in loop: {warms - 1 if warms > 1 else 0})")
    if best:
        print(f"best member: lr={best['lr']:.2e} "
              f"loss={best['loss']:.4f} launch={1e3*best['launch_s']:.0f}ms")
    print(f"array: {arr.summary}")
    print(f"events: {run.result.events.counts()}")
    print(f"report: {sup.launch_report()}")


if __name__ == "__main__":
    main()

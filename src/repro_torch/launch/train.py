"""Training launcher CLI of the port (counterpart of
``repro/launch/train.py``: the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 100 [--ckpt-dir DIR] [--data corpus.bin] [--device cpu]

The port trains on one device, so it always takes the reference's
one-device branch: ``cfg.reduced()``, at seq 64 and batch 8 unless
``--seq`` and ``--batch`` say otherwise (``--reduced`` is accepted and
changes nothing). ``--device`` defaults to ``cuda`` and raises where no
card is visible; it never falls back to the CPU. The Trainer provides
async checkpointing, preemption handling (SIGTERM -> checkpoint -> exit),
bounded step retry and resume (see ``repro_torch.train.trainer``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch_fn
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke config (always taken: one device)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_ckpt under the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default=None, help="packed .bin corpus path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    seq = args.seq or 64
    batch = args.batch or 8
    shape = ShapeConfig("cli", seq, batch, "train")
    print(f"arch={cfg.name} device={args.device} seq={seq} batch={batch}")

    batch_fn = make_batch_fn(cfg, shape, corpus=args.data)
    tc = TrainerConfig(ckpt_every=args.ckpt_every, peak_lr=args.lr,
                       total_steps=args.steps)
    if args.ckpt_dir:
        tc.ckpt_dir = args.ckpt_dir
    trainer = Trainer(cfg, batch_fn, tc, device=args.device)
    out = trainer.run(args.steps)
    print(f"done at step {out['step']}; last loss {out['losses'][-1]:.4f}"
          f"{' (preempted)' if out['preempted'] else ''}")


if __name__ == "__main__":
    main()

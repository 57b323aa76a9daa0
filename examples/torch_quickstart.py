"""Quickstart on the PyTorch port: train a reduced Qwen3 on synthetic data.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen3-0.6b] \
        [--steps 50] [--device cuda]

The port's public API end to end: config registry -> reduced config ->
fault-tolerant Trainer (checkpointing to a temporary directory) -> loss
curve. The params are drawn from a generator seeded with 0 on ``--device``
(the card unless the caller asks for the CPU); the loss must fall.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              param_dtype="float32", remat="none")
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"pattern={cfg.block_pattern[:4]}... device={args.device}")
    src = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8, seed=0)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=20, peak_lr=5e-3,
                           warmup=10, total_steps=args.steps, log_every=10)
        out = Trainer(cfg, src.batch, tc, device=args.device).run(args.steps)

    losses = out["losses"]
    k = min(5, len(losses))
    print(f"\nfirst-{k} mean loss {sum(losses[:k]) / k:.4f}  ->  "
          f"last-{k} mean loss {sum(losses[-k:]) / k:.4f}")
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()

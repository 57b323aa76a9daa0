"""Serving launcher CLI of the port: continuous batching over synthetic
requests (counterpart of ``repro/launch/serve.py``; same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 16 [--slots 4] [--device cpu]

``--arch`` takes any id the port's registry lists (qwen3-0.6b, xlstm-1.3b,
zamba2-2.7b, qwen3-14b, qwen2-1.5b, moonshot-v1-16b-a3b, mixtral-8x22b);
the launcher serves its reduced config in fp32.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              param_dtype="float32", remat="none")
    gen = torch.Generator(args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for _ in range(args.requests):
        plen = int(rng.integers(3, args.max_seq // 4))
        eng.submit(rng.integers(0, cfg.vocab_size, plen),
                   max_new=args.max_new)
    done = eng.run()
    dt = time.monotonic() - t0
    tokens = sum(len(r.tokens) for r in done.values())
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, {eng.stats['decode_steps']} ticks) "
          f"on {args.device}")


if __name__ == "__main__":
    main()

"""Serve a small model on the PyTorch port with continuously batched
requests.

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch zamba2-2.7b] \
        [--device cuda]

Requests of different prompt lengths stream through a fixed slot pool; the
engine prefills each admission exactly (no padding) and advances every
active slot with one batched decode step per tick. The params are drawn
from a generator seeded with 0 on ``--device``.
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
from repro_torch.train.step import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              param_dtype="float32", remat="none")
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=128, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    rids = []
    for _ in range(args.requests):
        plen = int(rng.integers(3, 24))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        rids.append(eng.submit(prompt, max_new=int(rng.integers(4, 16))))

    done = eng.run()
    dt = time.monotonic() - t0

    total_tokens = sum(len(r.tokens) for r in done.values())
    print(f"arch={cfg.name} slots={args.slots} device={dev}")
    print(f"served {len(done)} requests / {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s aggregate, "
          f"{eng.stats['decode_steps']} batched decode ticks, "
          f"{eng.stats['prefills']} prefills)")
    for rid in rids[:5]:
        r = done[rid]
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        print(f"  req {rid}: prompt={len(r.prompt):2d} new={len(r.tokens):2d} "
              f"ttft={ttft:7.1f}ms tokens={r.tokens[:8]}...")
    assert sorted(done) == rids, "every request is served"
    return eng, done


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where a full-width Trainer step's time goes on one CUDA card.

    python3 scripts/trainer_profile.py          # from the root of a checkout

qwen3-0.6b as configured (bf16 params, fp32 moments, 2 microbatches) on
one ``SyntheticLM`` 8 x 512 batch, through ``repro_torch.train.step``:

1. remat full (the config's) and remat none: six steps each, host-clock
   ms per step (each ends in reading the loss) and peak device memory;
2. under remat full, one step timed three ways: the host's enqueue time
   (until ``train_step`` returns), CUDA events around it, and the wall time
   to its end; the device is waiting on the host when the enqueue takes
   most of the events' time;
3. a ``cProfile`` of two steps, the top entries by own and by cumulative
   time.

The card's name and power limit are printed first; every number is this
run's.
"""
from __future__ import annotations

import cProfile
import dataclasses
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step, to_batch)

STEPS, TOP = 6, 30


def main():
    if not torch.cuda.is_available():
        sys.exit("trainer_profile: no CUDA card visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    base = get_config("qwen3-0.6b")
    src = SyntheticLM(base.vocab_size, 512, 8, seed=0)
    batch = to_batch(src.batch(0), "cuda")
    for remat in ("full", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        params, opt = init_train_state(cfg, device="cuda")
        step = make_train_step(cfg, peak_lr=1e-3, warmup=2, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch, i)
            float(m["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"remat {remat}: step ms {[round(x, 1) for x in ms]} (the "
              f"first warms up), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if remat == "full":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            params, opt, m = step(params, opt, batch, STEPS)
            enqueue = (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            print(f"one step: host enqueue {enqueue:.1f} ms, CUDA events "
                  f"{start.elapsed_time(end):.1f} ms, wall "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
            prof = cProfile.Profile()
            prof.enable()
            for i in range(2):
                params, opt, m = step(params, opt, batch, STEPS + 1 + i)
                float(m["loss"])
            prof.disable()
            for key in ("tottime", "cumulative"):
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats(key).print_stats(
                    TOP)
                print(out.getvalue(), flush=True)
        del params, opt
        torch.cuda.empty_cache()
    print(card)


if __name__ == "__main__":
    main()

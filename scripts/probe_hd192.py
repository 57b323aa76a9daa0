#!/usr/bin/env python3
"""The head_dim 192 regimes of both flash forwards, and rmsnorm at d 18432,
alone on one CUDA card (nemotron-4-340b's shapes), in about half a minute
of command with the build.

    python3 scripts/probe_hd192.py

Builds the kernels, prints ptxas's lines for the hd 192 instantiations
(registers, spills), the bf16 kernel's registers, shared memory and blocks
per SM and the fp32 kernel's blocks per SM, then holds each case against
its plain version with ``chip_smoke.py``'s functions: H:KV 12:1, 24:2 and 12:2 at T = 128 / 137 /
256 (a window of 64) and non-causal, T=1 at q_offset 76, T=37 at q_offset
63, in both dtypes, per row in bf16 where T >= 128; B=1 T=S=1000 H=96 KV=8
held per row and timed beside SDPA in bf16, held and timed in fp32; rmsnorm
1000 x 18432 bf16 held and timed beside ``F.rms_norm``. Ends with "probe
ok"; any disagreement raises.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    fwd_occupancy, sm90_occupancy)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_hd192: no CUDA card visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build.load()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    lines = build.BUILD_INFO.get("log", "").splitlines()
    for i, line in enumerate(lines):
        if "ILi192E" in line:
            for shown in lines[i:i + 3]:
                print("  ", shown.strip())
    print("sm90 occ hd192", sm90_occupancy(192), "fp32 occ",
          fwd_occupancy(192), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(1, 128, 128, 12, 1, 192, dtype, True, 0, 0),
                  (2, 137, 137, 24, 2, 192, dtype, True, 0, 0),
                  (1, 1, 77, 12, 1, 192, dtype, True, 0, 76),
                  (1, 37, 100, 12, 1, 192, dtype, True, 0, 63),
                  (1, 256, 256, 12, 1, 192, dtype, True, 64, 0),
                  (2, 128, 128, 12, 2, 192, dtype, False, 0, 0)]
    cases += [(1, 1000, 1000, 96, 8, 192, torch.bfloat16, True, 0, 0)]
    for c in cases:
        q, k, v, got, err, name = cs.hold_flash(gen, *c)
        if c[6] == torch.bfloat16 and c[1] >= 128:
            cs.check_flash_rows(q, k, v, got, name, c[8], causal=c[7])
        if c[1] == 1000:
            cs.time_flash(q, k, v, err)
    q, k, v, got, err, name = cs.hold_flash(gen, 1, 1000, 1000, 96, 8, 192,
                                            torch.float32, True)
    print(cs.time_flash_fwd(q, k, v, err), flush=True)
    x = cs.randn(gen, 1000, 18432, dtype=torch.bfloat16)
    g = (1 + 0.1 * cs.randn(gen, 18432)).to(torch.bfloat16)
    name = "rows=1000 d=18432 bfloat16"
    cs.time_rmsnorm(name, x, g, cs.hold_rmsnorm(name, x, g))
    print("probe ok", flush=True)


if __name__ == "__main__":
    main()

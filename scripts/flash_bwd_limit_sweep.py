#!/usr/bin/env python3
"""The bf16 flash backward's rounding against its per-row limits, on the CPU,
over many draws (about a minute):

    PYTHONPATH=src python3 scripts/flash_bwd_limit_sweep.py [--seeds 20]

For each case of ``tests/test_torch_flash_bwd_sm90.py`` (``CASES``, drawn
by that file's ``_bf16_inputs`` from seeds 70, 71, ...), the plain backward
with the kernels' rounding (P and dS in bf16,
``flash_attention_bwd_ref(..., bf16_operands=True)``) against the fp32
formulas on the same bf16 inputs: the worst ratio of a row's error to its
limit under ``chip_smoke.bf16_rows_ok`` (twice the output's own bf16
rounding) and under ``chip_smoke.flash_bwd_rows_ok`` (that plus the
operands' rounding bound), the draws over 1 under each, and the smallest
ratio of a run without the first 64 keys under the second (which must stay
over 1). Prints one line per case and a summary.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    tests = load("flash_bwd_tests", ROOT / "tests/test_torch_flash_bwd_sm90.py")
    smoke = tests._chip_smoke()
    from repro_torch.kernels import flash_attention_bwd_ref
    worst_old = worst_new = 0.0
    over_old = over_new = 0
    least_dropped = float("inf")
    for case in tests.CASES:
        old = new = 0.0
        n_old = n_new = 0
        dropped = float("inf")
        for seed in range(70, 70 + args.seeds):
            (q, k, v, o, lse, do), kw = tests._bf16_inputs(case, seed)
            want, bounds = tests._fp32_and_bounds(smoke, q, k, v, o, lse, do,
                                                  kw)
            got = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                          bf16_operands=True, **kw)
            with contextlib.redirect_stdout(io.StringIO()):
                r_old, _ = smoke.bf16_rows_ok("rounded", "", got, want)
                r_new, _ = smoke.flash_bwd_rows_ok("rounded", "", got, want,
                                                   bounds)
                r_drop, _ = smoke.flash_bwd_rows_ok(
                    "dropped", "", tests._without_first_keys(q, k, v, do, kw),
                    want, bounds)
            old, new = max(old, r_old), max(new, r_new)
            n_old += r_old > 1.0
            n_new += r_new > 1.0
            dropped = min(dropped, r_drop)
        print(f"{case}: output rounding alone worst {old:.3f}x ({n_old} of "
              f"{args.seeds} over); with the operands' bound worst {new:.3f}x "
              f"({n_new} over); without keys 0..63 least {dropped:.1f}x",
              flush=True)
        worst_old, worst_new = max(worst_old, old), max(worst_new, new)
        over_old += n_old
        over_new += n_new
        least_dropped = min(least_dropped, dropped)
    draws = args.seeds * len(tests.CASES)
    print(f"{draws} draws: output rounding alone worst {worst_old:.3f}x, "
          f"{over_old} over; flash_bwd_rows_ok worst {worst_new:.3f}x, "
          f"{over_new} over; without keys 0..63 least {least_dropped:.1f}x")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Layout variants of the bf16 rmsnorm backward (``csrc/rmsnorm_bwd_sm90.cu``)
at the Trainer's norm shapes, on one CUDA card.

    python3 scripts/rmsnorm_bwd_variants.py

For clusters of 2 (the source as it is), 4 and 8 blocks, the source is
rebuilt alone with its ``CLUSTER`` constant changed (nvcc with the
package's flags, under ``build/variants/``), and its C entry is called with
``bwd_plan``'s layout for that cluster size: how many clusters the card
holds at once (``rmsnorm_bwd_bf16_max_clusters``, one block an SM), the
SMs that makes, device ms per call (CUDA-graph replay,
``chip_smoke.device_ms``), the largest error against ``rmsnorm_bwd_ref`` and
whether two calls give the same bits. Beside them, one launch that moves
the same bytes: ``Tensor.copy_`` of half of them (read once, written once;
like the kernel's inputs here, they stay in the 50 MB L2 between calls).
Prints the card's name and power limit and one JSON line per row.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2048, 1024), (32768, 128), (16384, 128))   # rows, d
CLUSTERS = (2, 4, 8)


def variant(cs, cluster: int) -> ctypes.CDLL:
    """The source built alone with CLUSTER = ``cluster``."""
    src = cs.build.CSRC / "rmsnorm_bwd_sm90.cu"
    text, n = re.subn(r"constexpr int CLUSTER = \d+;",
                      f"constexpr int CLUSTER = {cluster};", src.read_text())
    assert n == 1, "no CLUSTER constant in the source"
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"rmsnorm_bwd_c{cluster}.cu", out / f"rmsnorm_bwd_c{cluster}.so"
    cu.write_text(text)
    subprocess.run([cs.build.nvcc(), *cs.build.NVCC_FLAGS, "-shared", "-I",
                    str(cs.build.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    if not torch.cuda.is_available():
        sys.exit("rmsnorm_bwd_variants: no CUDA card visible")
    print(cs.card_line(), flush=True)
    libs = {c: variant(cs, c) for c in CLUSTERS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(0)
    saved = rms.BWD_CLUSTER
    for rows, d in SHAPES:
        x, dy = (cs.randn(gen, rows, d, dtype=torch.bfloat16) for _ in range(2))
        g = (1 + 0.1 * cs.randn(gen, d)).to(torch.bfloat16)
        want = cs.rmsnorm_bwd_ref(x.float(), g.float(), dy.float(), eps=1e-6)
        half = torch.empty(3 * rows * d // 2, dtype=torch.bfloat16, device="cuda")
        dst = torch.empty_like(half)
        print(json.dumps({"shape": f"{rows}x{d}", "copy_same_bytes_ms":
                          cs.device_ms(lambda: dst.copy_(half), 50)}), flush=True)
        vec, group = rms.bwd_vec_group(0, d)
        for cluster, lib in libs.items():
            fits = ctypes.c_int(0)
            fn = lib.rmsnorm_bwd_bf16_max_clusters
            fn.argtypes, fn.restype = list(rms._BWD_OCC_ARGTYPES), ctypes.c_int
            cs.build.check(fn(vec, group, d, ctypes.byref(fits)), "max_clusters")
            entry = lib.rmsnorm_bwd_bf16
            entry.argtypes = list(rms._BWD_BF16_ARGTYPES)
            entry.restype = ctypes.c_int
            rms.BWD_CLUSTER = cluster
            try:
                p = rms.bwd_plan(0, rows, d, fits.value)
            finally:
                rms.BWD_CLUSTER = saved
            part = torch.empty(p.clusters, d, device="cuda")

            def call():
                dx, dg = torch.empty_like(x), torch.empty_like(g)
                cs.build.check(entry(
                    x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    dg.data_ptr(), part.data_ptr(), rows, d, 1e-6, p.vec,
                    p.group, p.clusters, p.rows_per_block,
                    torch.cuda.current_stream().cuda_stream),
                    "rmsnorm_bwd_bf16")
                return dx, dg

            first, again = call(), call()
            torch.cuda.synchronize()
            print(json.dumps({
                "shape": f"{rows}x{d}", "cluster": cluster,
                "clusters_held": fits.value, "sms": min(sms, p.blocks),
                "plan": p._asdict(), "ms": cs.device_ms(call, 50),
                "max_abs_err": [float((a.float() - b.float()).abs().max())
                                for a, b in zip(first, want)],
                "same_bits": all(torch.equal(a, b)
                                 for a, b in zip(first, again))}),
                flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where a step of the sLSTM backward walk (``csrc/slstm_scan_bwd.cu``)
goes, at xlstm's Trainer microbatch (B=4 T=512 nh=4 dh=512, wx fp32, r
bf16), on one CUDA card.

    python3 scripts/slstm_bwd_variants.py

The source is rebuilt alone (nvcc with the package's flags, under
``build/variants/``) as it is and as variants made by text substitution:

- ``two terms``: dpre split into two bf16 terms (hi, mid) instead of three,
  so the tensor cores' N is 2 x 4 batch rows, one n-tile instead of two: a
  lever that gives up the third term's accuracy;
- ``no exchange``: no partial dot sent, no wait for them (wrong results,
  the time without the exchange);
- ``no product``: no mma (wrong results, the time without the tensor
  cores' work; the B fragments are still loaded).

Each variant's C entry is called on the same inputs in turns (the list,
then reversed): device ms per call (CUDA-graph replay,
``chip_smoke.device_ms``), µs a step, dwx's and db's largest error against
``slstm_scan_bwd_ref`` over their largest magnitude, ptxas's registers and
spills. Then the source as it is with ``clock64`` stamps around each part
of a step (lane 0 of every warp of the first block, cycles a step averaged
over the walk). Prints the card's name and power limit, the SM clock, and
one JSON line per row.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEGMENTS = ("rank sum", "cell", "terms", "dwx stores", "barrier", "mma",
            "sums to send", "sends", "fetch", "next forward",
            "barrier + wait", "cluster barrier")
STAMP = "{ long long _n = clock64(); _acc[%d] += _n - _c; _c = _n; }\n"


def sub(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, f"not once in the source: {old[:60]!r}"
    return text.replace(old, new)


def two_terms(src: str) -> str:
    src = sub(src, "constexpr int NT = (3 * NB + 7) / 8;", "constexpr int NT = (2 * NB + 7) / 8;")
    src = sub(src, "if (n < 3 * NB) scratch", "if (n < 2 * NB) scratch")
    src = sub(src, "for (int term = 0; term < 3; ++term) {", "for (int term = 0; term < 2; ++term) {")
    return sub(src, """const float4 lo = *reinterpret_cast<const float4*>(
                            my_scratch + (2 * NB + b) * kScratchRow + row);""",
               "const float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);")


def no_exchange(src: str) -> str:
    src = src.replace("store_remote(to_recv", "if (0) store_remote(to_recv")
    src = sub(src, "if (more && tid == 0) mbar_expect(bar, B * dh * 4);", "")
    return sub(src, "if (more) mbar_wait(bar, (s >> 1) & 1);", "")


def no_product(src: str) -> str:
    return sub(src, "mma_bf16(acc[mt][nt], a[kt][mt], b[kt & 1][nt][0], b[kt & 1][nt][1]);",
               "acc[mt][nt][0] += __uint_as_float(a[kt][mt][0] & b[kt & 1][nt][0]);")


def stamped(src: str) -> str:
    """Cycles of each part of a step, summed over the walk, for lane 0 of
    each warp of block 0, read back by ``slstm_bwd_stamps``."""
    n = len(SEGMENTS)
    marks = [  # (text the stamp goes after, segment it closes)
        ("                    if (src < G) rec += part[src];\n            }\n", 0),
        ("            dm[k] = da;\n", 1),
        ("                        rows[n * cols + 8 * ((kk >> 3) ^ (n & 7)) + (kk & 7)] = tq[term];\n"
         "                    }\n                }\n", 2),
        ("                dbq[k][x] += dp[x];\n            }\n", 3),
        ("__syncthreads();  // dpre_t of the block's units and step s + 1's stage in place\n", 4),
        ("                                my_scratch);\n", 5),
        ("                                           hi.z + mid.z + lo.z, hi.w + mid.w + lo.w);\n"
         "                    }\n", 6),
        ("                                         v[j], to_bar[j] + bar_off);\n                    }\n", 7),
        ("        fetch(s + kStages - 1);  // into the stage that held step s - 1\n", 8),
        ("        if (more) forward(s + 1);\n", 9),
        ("        if (more) mbar_wait(bar, (s >> 1) & 1);\n", 10),
    ]
    for text, seg in marks:
        src = sub(src, text, text + STAMP % seg)
    src = sub(src, "            const Fwd& w = fw[k];\n",
              '            asm volatile("" ::"f"(rec));\n            const Fwd& w = fw[k];\n')
    src = sub(src, "    for (int s = 0; s < T_len; ++s) {\n",
              f"    long long _acc[{n}] = {{0}};\n    long long _c = clock64();\n"
              "    for (int s = 0; s < T_len; ++s) {\n")
    src = sub(src, "        cluster_wait();\n    }\n    cp_async_wait<0>();\n",
              "        cluster_wait();\n" + STAMP % (n - 1) + "    }\n    cp_async_wait<0>();\n"
              "    if (blockIdx.x == 0 && lane == 0)\n"
              f"        for (int i = 0; i < {n}; ++i) g_stamps[warp * {n} + i] = _acc[i];\n")
    src = sub(src, "namespace {\n\nconstexpr int kThreads",
              f"__device__ long long g_stamps[{8 * n}];\n\nnamespace {{\n\nconstexpr int kThreads")
    return src + ('\nextern "C" int slstm_bwd_stamps(long long* out) {\n'
                  "    return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, "
                  "sizeof(g_stamps)));\n}\n")


def build_all(cs, sources: dict) -> dict:
    """Each source built alone, all at once; name -> (library, ptxas lines)."""
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = "slstm_bwd_" + name.replace(" ", "_")
        (out / f"{stem}.cu").write_text(text)
        procs[name] = (stem, subprocess.Popen(
            [cs.build.nvcc(), *cs.build.NVCC_FLAGS, "-shared", "-I", str(cs.build.CSRC), "-o",
             str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        # the bf16-r, fp32-wx, 4-row tile, one-cell instantiation
        lines = log.splitlines()
        at = [i for i, line in enumerate(lines)
              if "Compiling entry" in line and "walk_kernelIf13__nv_bfloat16Li4ELi1E" in line]
        info = " ".join(line.replace("ptxas info    :", "").strip()
                        for line in lines[at[0] + 1:at[0] + 4]
                        if "spill" in line or "Used" in line) if at else ""
        libs[name] = (ctypes.CDLL(str(out / f"{stem}.so")), info)
    return libs


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    m = importlib.import_module("repro_torch.kernels.slstm_scan")
    if not torch.cuda.is_available():
        sys.exit("slstm_bwd_variants: no CUDA card visible")
    print(cs.card_line(), flush=True)
    src = (cs.build.CSRC / "slstm_scan_bwd.cu").read_text()
    variants = {"as is": src, "two terms": two_terms(src), "no exchange": no_exchange(src),
                "no product": no_product(src)}
    libs = build_all(cs, {**variants, "stamped": stamped(src)})
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    B, T, nh, dh = cs.SLSTM_BWD_TRAIN
    wx, r, b = cs.slstm_inputs(gen, B, T, nh, dh, torch.float32, True, torch.bfloat16)
    dhs = cs.randn(gen, B, T, nh, dh)
    _, (pre, steps) = m._forward(wx, r, b, trace=True)
    dstate = torch.zeros(3, B, nh, dh, device="cuda")
    want = m.slstm_scan_bwd_ref(wx, r, b, dhs)
    plan = m.slstm_bwd_plan(B, nh, dh, r.dtype)

    def entry(lib):
        fn = lib.slstm_scan_bwd
        fn.argtypes, fn.restype = list(m._BWD_ARGTYPES), ctypes.c_int
        dpre = torch.empty(B, T, nh, 4 * dh, device="cuda")
        db = torch.empty(nh, 4 * dh, device="cuda")

        def call():
            code = fn(r.data_ptr(), pre.data_ptr(), steps.data_ptr(), dhs.data_ptr(),
                      dstate.data_ptr(), dpre.data_ptr(), db.data_ptr(), m._DTYPES[wx.dtype],
                      m._DTYPES[r.dtype], B, T, nh, dh, plan.blocks, plan.resident_rows,
                      torch.cuda.current_stream().cuda_stream)
            cs.build.check(code, "slstm_scan_bwd variant")
            return dpre, db
        return call

    calls = {name: entry(libs[name][0]) for name in variants}
    errors = {}
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        errors[name] = {k: float((g - w).abs().max() / w.abs().max())
                        for k, g, w in zip(("dwx", "db"), got, (want[0], want[2]))}
    shape = f"B={B} T={T} nh={nh} dh={dh} wx fp32 r bf16"
    for name in list(calls) + list(calls)[::-1]:
        ms = cs.device_ms(calls[name], 3)
        print(json.dumps({"variant": name, "shape": shape, "ms": ms, "us_per_step": ms / T * 1e3,
                          "rel_err_vs_plain": errors[name], "ptxas": libs[name][1]}),
              flush=True)
    stamps_lib = libs["stamped"][0]
    entry(stamps_lib)()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (8 * len(SEGMENTS)))()
    stamps_lib.slstm_bwd_stamps.argtypes = [ctypes.c_void_p]
    cs.build.check(stamps_lib.slstm_bwd_stamps(ctypes.addressof(buf)), "slstm_bwd_stamps")
    for warp in range(8):
        row = {seg: round(buf[warp * len(SEGMENTS) + i] / T)
               for i, seg in enumerate(SEGMENTS)}
        print(json.dumps({"stamps": "cycles a step", "warp": warp, **row,
                          "total": sum(row.values())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

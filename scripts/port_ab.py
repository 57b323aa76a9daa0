#!/usr/bin/env python3
"""A/B of the PyTorch port against an older checkout, on one CUDA card.

    git archive <rev> | tar -x -C build/parent     # build/ is gitignored
    python3 scripts/port_ab.py --parent build/parent

Three comparisons, each in the order parent, this checkout, this checkout,
parent, so that a drift of the card or the host shows as a spread:

- ``flash_attention_fwd`` (the fp32 forward, with lse) and
  ``flash_attention_bwd`` at the member step's shape (B=4 T=S=512 H=16
  KV=8 hd=128, fp32, causal): the parent's ``csrc/flash_attention.cu`` and
  ``csrc/flash_attention_bwd.cu`` are each built alone into a library of
  their own under ``build/ab/`` and called through the same C entry as
  this checkout's; device ms per call from CUDA-graph replay
  (``chip_smoke.device_ms``), whether the two give the same bits, and
  their largest difference.
- Serving qwen3-0.6b at full width (bf16 weights from seed 0, 4 slots, 8
  requests of 32 new tokens, ``chip_smoke.py``'s prompts), one process per
  run, each serving twice and reporting the second: prefill ms per
  request, decode ms per step and tokens/s on the host clock.

Prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
SHAPE = (4, 512, 16, 8, 128)                 # B, T=S, H, KV, hd


def serve(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in rng.integers(100, 1501, size=8)]
    for _ in range(2):
        eng = ServeEngine(cfg, params, slots=4, max_seq=2048, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new=32)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats
    return {"serve": str(tree), "tokens_per_s": 32 * len(prompts) / wall,
            "prefill_ms": st["prefill_s"] / st["prefills"] * 1e3,
            "decode_ms": st["decode_s"] / st["decode_steps"] * 1e3}


def parent_entry(parent: Path, source: str, entry: str, argtypes):
    """``entry`` of the parent's ``source``, built alone into its own
    library (nvcc with this checkout's flags)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    lib = ROOT / "build" / "ab" / f"parent_{Path(source).stem}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cs.build.nvcc(), *cs.build.NVCC_FLAGS, "-shared", "-I",
                    str(parent / CSRC), "-o", str(lib),
                    str(parent / CSRC / source)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def ab_rows(kernel: str, parent_call, this_call) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    pairs = list(zip(parent_call(), this_call()))
    same = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    B, T, H, KV, hd = SHAPE
    shape = f"B={B} T=S={T} H={H} KV={KV} hd={hd} fp32 causal"
    return [{kernel: name, "shape": shape, "ms": cs.device_ms(fn, 10),
             "same_bits_as_parent": same, "max_abs_diff": diff}
            for name, fn in (("parent", parent_call), ("this", this_call),
                             ("this", this_call), ("parent", parent_call))]


def flash_fwd(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    argtypes = fa._ARGTYPES["flash_attention_fwd"]
    old = parent_entry(parent, "flash_attention.cu", "flash_attention_fwd",
                       argtypes)
    new = cs.build.function("flash_attention_fwd", argtypes)
    B, T, H, KV, hd = SHAPE
    gen = torch.Generator("cuda").manual_seed(0)
    q = cs.randn(gen, B, T, H, hd)
    k, v = (cs.randn(gen, B, T, KV, hd) for _ in range(2))

    def call(fn):
        o = torch.empty_like(q)
        lse = torch.empty(B, H, T, device="cuda")
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, T, T, H, KV, hd, 1, 0, 0,
                  1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        cs.build.check(code, "flash_attention_fwd")
        return o, lse

    return ab_rows("flash_attention_fwd", lambda: call(old), lambda: call(new))


def flash_bwd(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    old = parent_entry(parent, "flash_attention_bwd.cu",
                       "flash_attention_bwd", fa._BWD_ARGTYPES)
    B, T, H, KV, hd = SHAPE
    gen = torch.Generator("cuda").manual_seed(0)
    q, do = (cs.randn(gen, B, T, H, hd) for _ in range(2))
    k, v = (cs.randn(gen, B, T, KV, hd) for _ in range(2))
    o, lse = cs.flash_attention_ref(q, k, v, with_lse=True)
    o = o.contiguous()

    def parent_call():
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        code = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), torch.empty_like(lse).data_ptr(), B, T, T, H,
                   KV, hd, 1, 0, 0, 1.0 / math.sqrt(hd),
                   torch.cuda.current_stream().cuda_stream)
        cs.build.check(code, "parent flash_attention_bwd")
        return dq, dk, dv

    this_call = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)
    return ab_rows("flash_attention_bwd", parent_call, this_call)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--serve-one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve_one:
        print(json.dumps(serve(args.serve_one.resolve())), flush=True)
        return
    parent = args.parent.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for row in flash_fwd(parent) + flash_bwd(parent):
        print(json.dumps(row), flush=True)
    for tree in (parent, ROOT, ROOT, parent):
        subprocess.run([sys.executable, __file__, "--parent", str(parent),
                        "--serve-one", str(tree)], check=True)


if __name__ == "__main__":
    main()

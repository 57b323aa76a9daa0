#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases, in order; any failure raises and the script exits non-zero:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA).
2. Build the hand-written kernels from ``src/repro_torch/kernels/csrc``.
3. Hold each kernel against its plain PyTorch version on the card (fp32
   tolerance 2e-5, bf16 2e-2, as |got - want| <= tol + tol * |want|), and
   time kernel, plain version, a one-call PyTorch yardstick and the bound
   at the serving path's shapes.
4. Serve: ``ServeEngine`` at full-width qwen3-0.6b (28 layers, bf16 weights
   drawn from a seeded generator), 4 slots x 2048 positions, 8 requests.
   Checks every request finished, the kernels' launch counts (28 flash
   launches per prefill, 113 rmsnorm launches per prefill and per decode
   step), and teacher-forced logits of one request against the same model
   run through the plain versions on the card (within twice the bf16 noise
   floor, measured against an fp32 run). A traced window then gives the
   device's busy share and device time by kernel.
5. Print the kernels' JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN, so fp32 comparisons are full fp32.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (LAUNCHES, build, flash_attention,  # noqa: E402
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_ref)
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16 = 989e12          # tensor cores, bf16 FLOP/s
PEAK_F32 = 67e12            # CUDA cores, fp32 FLOP/s
HBM = 3.35e12               # bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
N_LAYERS = 28
NORMS_PER_PASS = 4 * N_LAYERS + 1  # ln1, q_norm, k_norm, ln2 per layer + final


def log(*a):
    print(*a, flush=True)


def require(ok, what: str = "check failed"):
    """A check of this run's results; raises (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def host_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` called back to back from Python: the
    cost a caller pays, host overhead included (events bracket the calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so host overhead is out of the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def max_err(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    require(torch.isfinite(got).all(), "non-finite kernel output")
    ok = bool((err <= tol + tol * want.abs()).all())
    return float(err.max()), ok


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
FLASH_GRID = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
              (1, 256, 256, 8, 1, 32), (1, 128, 384, 4, 4, 64),
              (2, 384, 384, 2, 2, 128)]      # tests/test_kernels.py:36-42
PATH_T = (137, 512, 1000, 2048)              # prefill lengths; H=16 KV=8
RMS_ROWS = (4, 1000, 16000)
REPORT_T = 1000                              # the JSON line's flash shape
REPORT_RMS = (16000, 128)                    # q_norm rows at T=1000


def check_flash(gen):
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, KV, hd in FLASH_GRID:
            cases.append((B, T, S, H, KV, hd, dtype, True, 0, S - T))
    for window in (64, 128, 256):
        cases.append((1, 256, 256, 4, 4, 64, torch.float32, True, window, 0))
    cases.append((2, 128, 128, 2, 2, 64, torch.float32, False, 0, 0))
    cases += [(1, 1, 77, 4, 2, 32, torch.float32, True, 0, 76),
              (1, 37, 100, 4, 2, 64, torch.bfloat16, True, 0, 63)]
    for T in PATH_T:
        cases.append((1, T, T, 16, 8, 128, torch.bfloat16, True, 0, 0))
    path = {}
    for B, T, S, H, KV, hd, dtype, causal, window, off in cases:
        q = randn(gen, B, T, H, hd, dtype=dtype)
        k = randn(gen, B, S, KV, hd, dtype=dtype)
        v = randn(gen, B, S, KV, hd, dtype=dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, flash_attention_ref(q, k, v, **kw), TOL[dtype])
        name = (f"B={B} T={T} S={S} H={H} KV={KV} hd={hd} "
                f"{str(dtype)[6:]} causal={causal} window={window} "
                f"q_offset={off}")
        log(f"flash_attention {name}: max_abs_err={err:.3e} "
            f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_attention disagrees with its plain version: {name}")
        if (B, H, KV, hd, dtype) == (1, 16, 8, 128, torch.bfloat16) \
                and T == S and causal and off == 0:
            path[T] = time_flash(q, k, v, err)
    return path


def time_flash(q, k, v, err):
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    pairs = T * (T + 1) // 2       # visible (t, s) pairs: causal, T == S
    flops = 4 * B * H * hd * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    bound = {"operations": flops / PEAK_BF16 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: flash_attention(q, k, v)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 20),
        "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v), 5),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B=1 T=S={T} H={H} KV={KV} hd={hd} bf16 causal",
    }
    log(f"  device time T={T}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel reaches "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from Python "
        f"{host_ms(kernel, 20):.4f} ms")
    return row


def check_rmsnorm(gen):
    path = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rows in RMS_ROWS:
            for d in (128, 1024):
                x = randn(gen, rows, d, dtype=dtype)
                g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
                got = rmsnorm(x, g, eps=1e-6)
                torch.cuda.synchronize()
                err, ok = max_err(got, rmsnorm_ref(x, g, eps=1e-6),
                                  TOL[dtype])
                name = f"rows={rows} d={d} {str(dtype)[6:]}"
                log(f"rmsnorm {name}: max_abs_err={err:.3e} "
                    f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
                require(ok, f"rmsnorm disagrees with its plain version: {name}")
                if dtype == torch.bfloat16:
                    path[(rows, d)] = time_rmsnorm(x, g, err)
    return path


def time_rmsnorm(x, g, err):
    rows, d = x.shape
    nbytes = x.element_size() * (2 * x.numel() + d)
    bound = {"operations": 4 * x.numel() / PEAK_F32 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    kernel = lambda: rmsnorm(x, g, eps=1e-6)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(lambda: rmsnorm_ref(x, g, eps=1e-6), 50),
        "library_ms": device_ms(lambda: F.rms_norm(x, (d,), g, 1e-6), 50),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"rows={rows} d={d} bf16",
    }
    log(f"  device time rows={rows} d={d}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); kernel moves "
        f"{nbytes / row['ms'] / 1e6:.1f} GB/s; one call from Python "
        f"{host_ms(kernel, 50):.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 4: serve
# --------------------------------------------------------------------------
@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (reference run
    on the card; the port itself never does this)."""
    saved = ops.attention, ops.norm
    ops.attention = lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw)
    ops.norm = lambda x, gain, **kw: rmsnorm_ref(x, gain, **kw)
    try:
        yield
    finally:
        ops.attention, ops.norm = saved


def teacher_forced(params, cfg, prompt, forced):
    """Logits of prefill and one decode step per forced token, [n+1, V]."""
    toks = torch.as_tensor(prompt[None], device="cuda")
    logits, cache = prefill(params, cfg, toks, pad=len(forced) + 1)
    out = [logits[0]]
    for i, tok in enumerate(forced):
        logits, cache = decode_step(
            params, cfg, torch.tensor([tok], device="cuda"), cache,
            torch.tensor([len(prompt) + i], device="cuda"))
        out.append(logits[0])
    return torch.stack(out).float()


def serve():
    cfg = get_config("qwen3-0.6b")
    require(cfg.n_layers == N_LAYERS and cfg.param_dtype == "bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    eng = ServeEngine(cfg, params, slots=4, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: qwen3-0.6b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, attn_impl "
        f"{cfg.attn_impl}), weights+cache set up in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1501, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    LAUNCHES.clear()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=32) for p in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    require(sorted(done) == rids, "not every request finished")
    require(all(len(done[r].tokens) == 32 for r in rids))
    require(all(0 <= t < cfg.vocab_size for r in rids for t in done[r].tokens))
    st = eng.stats
    want = {"flash_attention": N_LAYERS * st["prefills"],
            "rmsnorm": NORMS_PER_PASS * (st["prefills"] + st["decode_steps"])}
    log(f"serve: prompt lengths {lens.tolist()}, {st['prefills']} prefills, "
        f"{st['decode_steps']} decode steps, launches {launches} "
        f"(expected {want})")
    require(launches == want, f"launch counts {launches} != {want}")
    tokens = sum(len(done[r].tokens) for r in rids)
    metrics = {
        "prefill_ms_per_request": st["prefill_s"] / st["prefills"] * 1e3,
        "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
        "tokens_per_s": tokens / wall,
        "wall_s": wall,
        "generated_tokens": tokens,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("serve metrics: " + json.dumps(metrics))

    check_teacher_forced(params, cfg, prompts[0], done[rids[0]].tokens[:8])
    profile_serving(eng, prompts[:4])
    return launches, metrics


def check_teacher_forced(params, cfg, prompt, forced):
    """The kernel path's logits against the same model through the plain
    versions on the card (both bf16), and both against an fp32 plain run.

    Tolerance: twice the bf16 noise floor of this run, which is the plain
    bf16 path's own distance from fp32. The kernel path must be that close
    to the plain path and to fp32; a wrong mask or a wrong norm moves the
    logits by far more than bf16 rounding does through 28 layers.
    """
    before = dict(LAUNCHES)
    got = teacher_forced(params, cfg, prompt, forced)
    require(LAUNCHES["flash_attention"] == before["flash_attention"] + N_LAYERS)
    mid = dict(LAUNCHES)
    with plain_versions():
        plain = teacher_forced(params, cfg, prompt, forced)
        params32 = tree_map(lambda t: t.float(), params)
        ref32 = teacher_forced(params32, cfg, prompt, forced)
        del params32
    require(dict(LAUNCHES) == mid, "the plain reference launched a kernel")
    require(got.shape == (len(forced) + 1, cfg.vocab_size))
    require(torch.isfinite(got).all())
    diff = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    to32 = float((got - ref32).abs().max())
    floor = float((plain - ref32).abs().max())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"teacher-forced logits (prefill + {len(forced)} decode steps, "
        f"prompt {len(prompt)}): kernel vs plain max|diff| {diff:.4e} beside "
        f"max|logit| {scale:.4e} (ratio {diff / scale:.4e}); kernel vs fp32 "
        f"{to32:.4e}; bf16 noise floor (plain vs fp32) {floor:.4e}, tol "
        f"2x that; argmax agreement {agree:.3f}")
    require(diff <= 2 * floor, "kernel path disagrees with the plain path")
    require(to32 <= 2 * floor, "kernel path further from fp32 than plain")


def profile_serving(eng, prompts):
    """Trace the engine serving a few more requests: device busy share of
    the window and device time by kernel (the tracer's own host cost makes
    the idle share an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, max_new=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    groups = {"flash_attention": 0.0, "rmsnorm": 0.0, "matmul": 0.0,
              "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "flash_fwd_kernel" in name else
                 "rmsnorm" if "rmsnorm_kernel" in name else
                 "matmul" if any(w in name for w in ("gemm", "cutlass",
                                                      "xmma", "sm90_"))
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
    log(f"profile: {len(prompts)} requests x 8 tokens (traced), wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}), {len(kernels)} kernel names; device ms by "
        f"group {json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible; this script runs only "
                 "on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()                                       # phase 1
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}; tf32 off")

    t0 = time.perf_counter()                                 # phase 2
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  {line.strip()}")

    gen = torch.Generator("cuda").manual_seed(0)             # phase 3
    flash_rows = check_flash(gen)
    rms_rows = check_rmsnorm(gen)

    launches, metrics = serve()                              # phase 4

    kernels = [                                              # phase 5
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:121",
         "launches": launches["flash_attention"], **flash_rows[REPORT_T]},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:35",
         "launches": launches["rmsnorm"], **rms_rows[REPORT_RMS]},
    ]
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms")))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

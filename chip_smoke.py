#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases, in order; any failure raises and the script exits non-zero:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA).
2. Build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once); log ptxas's registers, shared memory
   and spills, the tensor-core flash kernel's dynamic shared memory, and the
   fp32 flash forward and backward kernels' shared memory and blocks per
   SM.
3. The serve paths' bf16 GEMMs (prefill and decode rows) against the fp32
   product of the same operands rounded to bf16, with
   ``allow_bf16_reduced_precision_reduction`` at its default and False:
   the worst error in bf16 ulps per shape (at most one at the default),
   and whether the flag changes a bit (a split-K GEMM reducing its
   partials in bf16 would).
4. Hold each kernel against its plain PyTorch version on the card (fp32
   tolerance 2e-5, bf16 2e-2, as |got - want| <= tol + tol * |want|, each
   output at its own dtype's tolerance), on the grids of
   ``tests/test_kernels.py`` and at the serving paths' shapes, and time
   kernel, plain version, a one-call PyTorch yardstick where one exists and
   the bound: flash_attention (every case in fp32, the CUDA-core kernel,
   and in bf16, the tensor-core kernel: causal, three windows, non-causal,
   T=1 at q_offset 76, T=37/S=100 at q_offset 63, then bf16 prefill
   lengths, each also held per row against the fp32 result relative to
   the row's RMS), rmsnorm (both dtypes, the vector path and the scalar
   one: d=100 and a view 16-byte misaligned, the q_norm decode rows
   64 x 128, and in fp32 every norm shape of both training paths),
   ssd_scan (outputs and final states, with and without an initial state,
   with the mLSTM normalizer, and one path case drawn like the served
   model: slow forgetting, exponential input gates; timed at each path
   length), slstm_scan (outputs and final states; path cases at every
   path length, fp32 r at dh=512 whose rows beyond shared memory come from
   L2, and B=4; each timed, in µs per step too; the cluster shape and how
   many such clusters the card holds at once). Then the member step's
   backward kernels, in fp32, against autograd of the plain versions, each
   gradient within 1e-4 of its largest magnitude: flash_attention_bwd (hd 32
   and 128, GQA group 2, causal, T = 32 / 137 / 512 / 1000 with B.T >= 2048
   at the larger T, one q_offset > 0 and one window case, one hd 64 case;
   the fp32 forward's output beside it; a run without the first key tile
   must fail the check; two calls at T=512 and T=137, hd 128, must give the
   same bits; the delta, dk/dv and dq kernels also timed apart; the fp32
   forward's lse against the plain lse in every case and in the run without
   the first key tile, whose first 64 rows see no key: within 1e-5 as
   above, +inf rows identical; two forward calls at T=512 the same bits;
   the forward timed at T=512, B=3 T=1000 and B=8 T=32 hd 32)
   and rmsnorm_bwd (every norm shape of both training paths and a view off
   16-byte alignment, the scalar path); a bf16 backward must raise. Each is
   timed beside its bound, its plain backward and the backward of
   ``F.scaled_dot_product_attention`` (fp32, GQA) or ``F.rms_norm``.
5. Serve: ``ServeEngine`` at full width, bf16 weights drawn from a seeded
   generator, 4 slots, 8 requests (prompt lengths from ``default_rng(0)`` in
   [100, 1500], 32 new tokens each), for two models in turn:
   - qwen3-0.6b (28 layers, 2048 positions): 28 flash launches per prefill,
     113 rmsnorm launches per prefill and per decode step;
   - xlstm-1.3b (48 blocks, 42 mLSTM + 6 sLSTM): 42 ssd_scan and 6
     slstm_scan launches per prefill (one ssd_scan call, its two kernels,
     computes an mLSTM layer's output and normalizer), 55 rmsnorm launches
     per prefill and per decode step.
   Each checks every request finished, the exact launch counts (set to 0
   just before the phase and read just after), and teacher-forced logits of
   one request against the same model run through the plain versions on the
   card (bf16 within twice the bf16 noise floor, measured against an fp32
   run; fp32 weights within the floor). A traced window then gives the
   device's busy share and device time by kernel, and shows that bf16
   serving ran no fp32 (CUDA-core) flash kernel.
5b. Train: the sweep's member step (``repro_torch.launch.sweep``:
   ``forward_loss`` -> autograd through the kernels' Functions ->
   ``adamw_update``), TF32 off, params in fp32:
   - qwen3-0.6b at full width (28 layers, vocab 151936, tied; random from
     seed 0) on one fixed 4 x 512 batch: one step with the kernels against
     the same step through the plain versions (loss, grad norm, every
     gradient and updated leaf), then 8 steps at lr 1e-3 with exactly 28
     flash_attention, 28 flash_attention_bwd, 113 rmsnorm and 113
     rmsnorm_bwd launches each and a falling loss, then one traced step,
     recorded after a warm-up step (busy share, device ms by group);
   - the sweep's own member (``member_config``: 4 layers, hd 32, vocab
     256): one step held against its plain step as above, then 16
     members x 5 steps on ``SyntheticLM(256, 32, 8, seed=0)`` at
     lr ``np.geomspace(1e-4, 3e-2, 16)``, one after another, with exactly
     4 / 4 / 17 / 17 launches per step; then 20 ticks of a 2-slot engine
     on the last member's trained params: no param leaf requires grad, no
     cache leaf carries autograd state, and the tokens equal an engine's on
     a detached copy.
5c. The sweep's command line (``repro_torch.launch.sweep``: preposition,
   supervisor, one task array of members on the inline backend):
   - ``python -m repro_torch.launch.sweep`` as a user runs it (16 members
     x 5 steps on the card) in a subprocess with ``PYTHONPATH=<root>/src``
     under a timeout, finding phase 2's library: exit 0 and ``launched
     16/16 members``; its process wall time, ``prepositioned in`` and
     members/s are logged;
   - ``run_sweep`` with the same defaults in this process: warm cache
     ``{warms 1, hits 16, misses 0}``, 16 of 16 ok, exactly 81 member
     steps' launches (the warm step and 16 x 5), the prepositioned params
     bit-equal to a fresh seed-0 init after the sweep, the final losses
     within 1e-6 of 5b's hand-run sweep (bit-equality logged); member
     launch times logged;
   - the supervisor at full width (qwen3-0.6b fp32, 28 layers, 5b's
     seed-0 params and 4 x 512 batch): prepositioned through the warm
     cache (``build_s``, ``first_step_s`` logged), then 3 members x 3 steps
     at lr 1e-3, 1e-3, 3e-4, launched one at a time under the quota of one
     card: 3 hits, exactly 10 steps' launches, members 0 and 1 the same
     losses bit for bit, every first loss 5b's step-0 loss within 1e-6;
     launch times, step times and the peak memory logged.
6. Print the kernels' JSON line (the fp32 forward and both backward
   kernels with their training and sweep launches beside the serving
   kernels), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN, so fp32 comparisons are full fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import SweepSupervisor  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import (LAUNCHES, build, flash_attention,  # noqa: E402
                                 flash_attention_bwd, flash_attention_bwd_ref,
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref,
                                 slstm_scan, slstm_scan_ref, ssd_scan,
                                 ssd_scan_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _forward as flash_forward, bwd_occupancy, fwd_occupancy, sm90_smem_bytes)
from repro_torch.kernels.rmsnorm import plan as rmsnorm_plan  # noqa: E402
from repro_torch.kernels.slstm_scan import (slstm_max_clusters,  # noqa: E402
                                            slstm_plan)
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.launch.sweep import (build_member_step,  # noqa: E402
                                      loss_and_grads, member_config,
                                      run_sweep, to_batch)
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16 = 989e12          # tensor cores, bf16 FLOP/s
PEAK_F32 = 67e12            # CUDA cores, fp32 FLOP/s
HBM = 3.35e12               # bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
QWEN_LAYERS = 28
QWEN_NORMS = 4 * QWEN_LAYERS + 1   # ln1, q_norm, k_norm, ln2 per layer + final
XLSTM_MLSTM, XLSTM_SLSTM = 42, 6
XLSTM_NORMS = XLSTM_MLSTM + 2 * XLSTM_SLSTM + 1   # ln1s, sLSTM ff_ln, final


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


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def compare(kernel: str, name: str, got, want) -> float:
    """Every output of a kernel against its plain version's, each at its own
    dtype's tolerance; returns the largest error."""
    errs = [max_err(g, w, TOL[w.dtype]) for g, w in zip(got, want)]
    err, ok = max(e for e, _ in errs), all(o for _, o in errs)
    log(f"{kernel} {name}: max_abs_err={err:.3e} over {len(errs)} outputs "
        f"{'ok' if ok else 'FAIL'} ({', '.join(f'{e:.2e}' for e, _ in errs)})")
    require(ok, f"{kernel} disagrees with its plain version: {name}")
    return err


# --------------------------------------------------------------------------
# phase 3: bf16 GEMMs of the serving paths, split-K reduction precision
# --------------------------------------------------------------------------
SPLITK_SHAPES = [      # (model, GEMM, K, N, weight is a transposed [N, K])
    ("qwen3-0.6b", "q", 1024, 2048, False),
    ("qwen3-0.6b", "k / v", 1024, 1024, False),
    ("qwen3-0.6b", "o", 2048, 1024, False),
    ("qwen3-0.6b", "mlp gate / up", 1024, 3072, False),
    ("qwen3-0.6b", "mlp down", 3072, 1024, False),
    ("qwen3-0.6b", "lm head (tied)", 1024, 151936, True),
    ("xlstm-1.3b", "up_x / up_z", 2048, 4096, False),
    ("xlstm-1.3b", "down", 4096, 2048, False),
    ("xlstm-1.3b", "lm head (tied)", 2048, 50304, True),
]
SPLITK_ROWS = (1000, 4)          # prefill rows; decode rows at 4 slots


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps, each ulp taken at the larger of
    |want| and the RMS of want's row: an output that cancels to near 0 would
    otherwise count the fp32 rounding of its terms as thousands of ulps."""
    want = want.float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    scale = torch.maximum(want.abs(), rms).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def check_splitk(gen):
    """``torch.matmul`` on bf16 operands against their fp32 product rounded
    to bf16 (TF32 off, so that product is full fp32), with
    ``allow_bf16_reduced_precision_reduction`` at its default and False: a
    split-K GEMM that reduces its partials in bf16 is off by more than the
    one ulp that rounding the same fp32 sum in another order can give.
    Logs per shape the worst error in ulps, the share of outputs whose bits
    differ from the reference and the time at each setting, and whether the
    two settings gave the same bits; fails if the default setting is off by
    more than one ulp; returns the worst error in ulps at each setting."""
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    worst = {True: 0.0, False: 0.0}
    try:
        for model, name, K, N, tied in SPLITK_SHAPES:
            w = randn(gen, *((N, K) if tied else (K, N)),
                      dtype=torch.bfloat16, scale=1 / math.sqrt(K))
            w = w.T if tied else w
            for M in SPLITK_ROWS:
                x = randn(gen, M, K, dtype=torch.bfloat16)
                want = (x.float() @ w.float()).to(torch.bfloat16)
                cells, outs = [], []
                for setting in (True, False):
                    flags.allow_bf16_reduced_precision_reduction = setting
                    got = torch.matmul(x, w)
                    ulps = bf16_ulps(got, want)
                    worst[setting] = max(worst[setting], ulps)
                    outs.append(got)
                    cells.append(
                        f"{setting}: {ulps:.2f} ulp, "
                        f"{float((got != want).float().mean()):.3%} differ, "
                        f"{device_ms(lambda: torch.matmul(x, w), 10):.4f} ms")
                log(f"splitk {model} {name} M={M} K={K} N={N}: "
                    + "; ".join(cells) + "; same bits at both settings: "
                    + str(torch.equal(*outs)))
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    log(f"splitk: default allow_bf16_reduced_precision_reduction={default}; "
        f"worst error True {worst[True]:.2f} ulp, False {worst[False]:.2f} "
        f"ulp")
    # the port's matmul (models/common.py) relies on fp32 accumulation
    require(worst[default] <= 1, "bf16 GEMM off by more than one ulp of its "
            "fp32 product: reduced-precision split-K reduction")
    return worst


# --------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# --------------------------------------------------------------------------
FLASH_GRID = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
              (1, 256, 256, 8, 1, 32), (1, 128, 384, 4, 4, 64),
              (2, 384, 384, 2, 2, 128)]      # tests/test_kernels.py:36-42
PATH_T = (137, 512, 1000, 1291, 2048)        # prefill lengths; H=16 KV=8
RMS_ROWS = (4, 1000, 16000)
RMS_EXTRA = ((64, 128), (4, 100), (1000, 100))   # q_norm decode rows; tails
TRAIN_NORM_SHAPES = [  # rows, d: every norm of both training paths (fp32)
    (2048, 1024), (2048 * 16, 128), (2048 * 8, 128),   # full width, B.T=2048
    (256, 128), (256 * 4, 32), (256 * 2, 32)]         # sweep member, B.T=256
REPORT_T = 1000                              # the JSON line's flash shape
REPORT_RMS = "rows=16000 d=128 bfloat16"     # q_norm rows at T=1000


def check_flash(gen):
    """Every case in fp32 (the CUDA-core kernel) and bf16 (the tensor-core
    kernel), then the bf16 prefill shapes of the serving path."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, KV, hd in FLASH_GRID:
            cases.append((B, T, S, H, KV, hd, dtype, True, 0, S - T))
        for window in (64, 128, 256):
            cases.append((1, 256, 256, 4, 4, 64, dtype, True, window, 0))
        cases += [(2, 128, 128, 2, 2, 64, dtype, False, 0, 0),
                  (1, 1, 77, 4, 2, 32, dtype, True, 0, 76),
                  (1, 37, 100, 4, 2, 64, dtype, True, 0, 63)]
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
            check_flash_rows(q, k, v, got, name)
            path[T] = time_flash(q, k, v, err)
    return path


def row_rel_err(got, want) -> float:
    """The largest error in any (batch, position, head) row of ``got``,
    relative to the RMS of that row of ``want``."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=-1) / rms).max())


def check_flash_rows(q, k, v, got, name):
    """At a prefill shape, where outputs are ~0.05 and 2e-2 absolute would
    pass a kernel that dropped a KV tile: the bf16 kernel's error per row
    against the plain version in fp32 (same bf16 inputs), relative to the
    row's RMS, within twice the plain version's own bf16 rounding of the
    same rows. A plain run without the first 64 keys of the last rows must
    fail the same limit, or the check could not see a missing tile."""
    T = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_attention_ref(qf, kf, vf)
    limit = 2 * row_rel_err(want.to(torch.bfloat16), want)
    err = row_rel_err(got, want)
    dropped = row_rel_err(flash_attention_ref(
        qf, kf, vf, window=T - 64).to(torch.bfloat16), want)
    ok = err <= limit < dropped
    log(f"  per row {name}: max |err| / row RMS {err:.3e}, limit {limit:.3e} "
        f"(2x the bf16 rounding of the fp32 result), first tile dropped "
        f"{dropped:.3e} {'ok' if ok else 'FAIL'}")
    require(err <= limit, f"flash_attention rows off the fp32 result: {name}")
    require(dropped > limit, f"per-row check cannot see a dropped tile: {name}")


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
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel / sdpa "
        f"{row['ms'] / row['library_ms']:.3f}, {row['bound_ms'] / row['ms']:.1%} "
        f"of the bound, {flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from "
        f"Python {host_ms(kernel, 20):.4f} ms")
    return row


def rmsnorm_cases(gen, dtype):
    """(name, x, g): the grid, the q_norm decode rows, tails of d = 100, in
    fp32 the training paths' norm shapes, and two contiguous views off 16-byte alignment: ``x[1:]`` of a [1001, 100]
    tensor (200 bytes in: the scalar path in bf16; 400 bytes, aligned, in
    fp32) and rows of 1024 starting one element into a flat buffer (the
    scalar path in both dtypes, a row too wide to hold: streamed)."""
    shapes = [(rows, d) for rows in RMS_ROWS for d in (128, 1024, 2048)]
    shapes += RMS_EXTRA
    if dtype == torch.float32:
        shapes += TRAIN_NORM_SHAPES
    for rows, d in shapes:
        x = randn(gen, rows, d, dtype=dtype)
        g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
        yield f"rows={rows} d={d} {str(dtype)[6:]}", x, g
    table = randn(gen, 1001, 100, dtype=dtype)
    flat = randn(gen, 1000 * 1024 + 1, dtype=dtype)
    for base, view in ((table, table[1:]), (flat, flat[1:].view(1000, 1024))):
        d = view.shape[-1]
        g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
        require(view.is_contiguous())
        yield (f"rows=1000 d={d} {str(dtype)[6:]} view at byte offset "
               f"{view.data_ptr() - base.data_ptr()}"), view, g


def check_rmsnorm(gen):
    path = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, x, g in rmsnorm_cases(gen, dtype):
            got = rmsnorm(x, g, eps=1e-6)
            torch.cuda.synchronize()
            err, ok = max_err(got, rmsnorm_ref(x, g, eps=1e-6), TOL[dtype])
            vec, group, held = rmsnorm_plan(
                x.data_ptr() | g.data_ptr() | got.data_ptr(), x.shape[-1],
                x.element_size())
            log(f"rmsnorm {name}: path vec={vec} group={group} "
                f"{'held' if held else 'streamed'} "
                f"max_abs_err={err:.3e} tol={TOL[dtype]:.0e} "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"rmsnorm disagrees with its plain version: {name}")
            if dtype == torch.bfloat16:
                path[name] = time_rmsnorm(name, x, g, err)
    return path


def time_rmsnorm(name, x, g, err):
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
        "shape": name,
    }
    log(f"  device time {name}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); kernel / "
        f"F.rms_norm {row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound, moves "
        f"{nbytes / row['ms'] / 1e6:.1f} GB/s; one call from Python "
        f"{host_ms(kernel, 50):.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 4, backward: the member step's gradient kernels
# --------------------------------------------------------------------------
GRAD_TOL = 1e-4       # fp32, of each gradient's largest magnitude
FLASH_BWD_CASES = [   # B, T, S, H, KV, hd, window, q_offset
    *[(B, T, T, 4, 2, 32, 0, 0)            # the sweep member's heads
      for B, T in ((8, 32), (2, 137), (4, 512), (3, 1000))],
    *[(B, T, T, 16, 8, 128, 0, 0)          # qwen3-0.6b at full width
      for B, T in ((8, 32), (2, 137), (4, 512), (3, 1000))],
    (1, 100, 300, 16, 8, 128, 0, 200),     # q_offset > 0
    (2, 512, 512, 4, 2, 32, 128, 0),       # window
    (2, 200, 200, 8, 2, 64, 0, 0),         # hd 64, GQA group 4
]
FLASH_BWD_REPORT = (4, 512, 16, 8, 128)    # B, T, H, KV, hd: the member step
FLASH_BWD_REPEAT = ((4, 512, 16, 8, 128), (2, 137, 16, 8, 128))  # bit-identical
FLASH_FWD_TIMED = ((3, 1000, 16, 8, 128), (8, 32, 4, 2, 32))  # + the report
LSE_TOL = 1e-5        # the fp32 forward's lse, as |err| <= tol + tol * |want|
RMS_BWD_REPORT = "rows=2048 d=1024"                    # ln1 / ln2 / final


def grad_device_ms(forward, inputs, grad, iters: int) -> float:
    """Mean device time of one ``torch.autograd.grad`` through
    ``forward(*inputs)`` (a library's backward): the forward runs once on
    the capture stream, since autograd runs each node's backward on its
    forward's stream, then ``iters`` backward calls are captured in one
    CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*inputs)
        for _ in range(3):
            torch.autograd.grad(out, inputs, grad, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            torch.autograd.grad(out, inputs, grad, retain_graph=True)
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


def check_grads(kernel: str, name: str, got, want, tol: float = GRAD_TOL):
    """Each gradient against autograd's through the plain version, within
    ``tol`` of that tensor's largest magnitude (fp32 sums of up to a few
    thousand terms in another order stay ~100x inside it; a dropped key tile
    or row is off by a large share of it). Returns the largest such error."""
    errs = []
    for g, w in zip(got, want):
        require(g.shape == w.shape and torch.isfinite(g).all(),
                f"{kernel}: gradient of shape {tuple(g.shape)} not finite or "
                f"not {tuple(w.shape)}: {name}")
        scale = float(w.float().abs().max())
        errs.append(float((g.float() - w.float()).abs().max()) / max(scale,
                                                                     1e-30))
    ok = max(errs) <= tol
    log(f"{kernel} {name}: max |err| / max |grad| "
        f"{', '.join(f'{e:.2e}' for e in errs)}, tol {tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{kernel} disagrees with autograd of its plain version: "
            f"{name}")
    return max(errs)


def flash_grads(q, k, v, do, attend, **kw):
    """(out, dq, dk, dv) through ``attend`` (the kernel's Function or the
    plain version) with fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = attend(*leaves, **kw)
    return (out.detach(), *torch.autograd.grad(out, leaves, do))


def check_flash_bwd(gen):
    """The fp32 forward with lse and the backward kernels against autograd
    of the plain version (fp32 on the card); a run without the first key
    tile must fail; bf16 gradients must raise. Returns the timed rows of the
    backward and of the fp32 forward at the member step's shape."""
    rows = None
    for B, T, S, H, KV, hd, window, off in FLASH_BWD_CASES:
        q, do = (randn(gen, B, T, H, hd) for _ in range(2))
        k, v = (randn(gen, B, S, KV, hd) for _ in range(2))
        kw = dict(causal=True, window=window, q_offset=off)
        out, *got = flash_grads(q, k, v, do, flash_attention, **kw)
        torch.cuda.synchronize()
        ref_out, *want = flash_grads(q, k, v, do, flash_attention_ref, **kw)
        name = (f"B={B} T={T} S={S} H={H} KV={KV} hd={hd} fp32 causal "
                f"window={window} q_offset={off}")
        fwd_err = compare("flash_attention", f"{name}, forward with lse",
                          (out,), (ref_out,))
        check_flash_lse(q, k, v, kw, name)
        err = check_grads("flash_attention_bwd", name, got, want)
        if (B, T, H, KV, hd) in FLASH_BWD_REPEAT:
            check_flash_bwd_repeats(q, k, v, do, name)
        if (B, T, H, KV, hd) in FLASH_FWD_TIMED:
            time_flash_fwd(q, k, v, fwd_err)
        if (B, T, H, KV, hd) == FLASH_BWD_REPORT:
            check_flash_fwd_repeats(q, k, v, name)
            rows = time_flash_bwd(q, k, v, do, err, fwd_err)
        if (B, T, hd, window, off) == (2, 137, 128, 0, 0):
            check_flash_bwd_dropped_tile(q, k, v, do, want)
    q = randn(gen, 1, 64, 4, 32, dtype=torch.bfloat16).requires_grad_(True)
    kv = randn(gen, 1, 64, 2, 32, dtype=torch.bfloat16)
    out = flash_attention(q, kv, kv)
    try:
        torch.autograd.grad(out, q, torch.ones_like(out))
    except NotImplementedError as e:
        log(f"flash_attention_bwd bf16 on the card raises: {e}")
    else:
        require(False, "a bf16 flash backward ran on the card")
    return rows


def check_flash_lse(q, k, v, kw, name):
    """The fp32 forward's lse against the plain version's: rows with a
    visible key within ``LSE_TOL``, the rows without one +inf in both.
    Returns the number of +inf rows."""
    _, got = flash_forward(q, k, v, kw["causal"], kw["window"],
                           kw["q_offset"], with_lse=True)
    _, want = flash_attention_ref(q, k, v, with_lse=True, **kw)
    inf = torch.isinf(want)
    same_inf = torch.equal(got[inf], want[inf])
    finite = got[~inf]
    err = (finite - want[~inf]).abs()
    ok = (same_inf and bool(torch.isfinite(finite).all())
          and bool((err <= LSE_TOL + LSE_TOL * want[~inf].abs()).all()))
    log(f"flash_attention {name}, lse: max_abs_err="
        f"{float(err.max()) if err.numel() else 0.0:.3e} over "
        f"{finite.numel()} rows, {int(inf.sum())} +inf rows "
        f"{'identical' if same_inf else 'DIFFER'}, tol {LSE_TOL:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"flash_attention lse disagrees with the plain lse: {name}")
    return int(inf.sum())


def check_flash_fwd_repeats(q, k, v, name):
    """Two calls of the fp32 forward on the same inputs give the same bits
    in the output and the lse (every sum runs in a fixed order)."""
    first = flash_forward(q, k, v, True, 0, 0, with_lse=True)
    second = flash_forward(q, k, v, True, 0, 0, with_lse=True)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"flash_attention {name}: two forward calls bit-identical in out, "
        f"lse: {same}")
    require(all(same), f"the fp32 flash forward is not deterministic: {name}")


def check_flash_bwd_repeats(q, k, v, do, name):
    """Two calls of the backward kernels on the same inputs give the same
    bits: every gradient element is summed in a fixed order."""
    o, lse = flash_attention_ref(q, k, v, with_lse=True)
    o = o.contiguous()
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"flash_attention_bwd {name}: two calls bit-identical in dq, dk, dv: "
        f"{same}")
    require(all(same), f"flash_attention_bwd is not deterministic: {name}")


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, summed by name
    over a profiler trace of ``iters`` calls after three warm-up calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.key] += e.self_device_time_total / 1e3 / iters
    return times


def check_flash_bwd_dropped_tile(q, k, v, do, want):
    """The kernels run without the first 64 keys (k, v from key 64 on at
    q_offset -64: rows 0..63 see no key) must fail ``check_grads``."""
    T = q.shape[1]
    k64, v64 = k[:, 64:].contiguous(), v[:, 64:].contiguous()
    kw = dict(causal=True, window=0, q_offset=-64)
    n_inf = check_flash_lse(q, k64, v64, kw, f"T={T}, first key tile "
                            "dropped, q_offset -64")
    require(n_inf == q.shape[0] * q.shape[2] * 64,
            "the rows without a visible key are not the first 64")
    _, dq, dk, dv = flash_grads(q, k64, v64, do, flash_attention,
                                q_offset=-64)
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 64, 0))
    try:
        check_grads("flash_attention_bwd", f"T={T}, first key tile dropped",
                    (dq, pad(dk), pad(dv)), want)
    except RuntimeError:
        log(f"flash_attention_bwd T={T}: the run without the first key tile "
            "fails the check, as it must")
    else:
        require(False, "the gradient check cannot see a dropped key tile")


def time_flash_bwd(q, k, v, do, err, fwd_err):
    B, T, H, hd = q.shape
    KV = k.shape[2]
    o, lse = flash_attention_ref(q, k, v, with_lse=True)
    o = o.contiguous()
    pairs = T * (T + 1) // 2
    flops = 2.5 * 4 * B * H * hd * pairs
    nbytes = 4 * (4 * q.numel() + 4 * k.numel() + 2 * lse.numel())
    bound = {"operations": flops / PEAK_F32 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 5),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse,
                                                              do), 2),
        "library_ms": grad_device_ms(sdpa, (qt, kt, vt), do.transpose(1, 2),
                                     5),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T=S={T} H={H} KV={KV} hd={hd} fp32 causal",
    }
    by_name = device_ms_by_kernel(kernel, 20)
    row["split_ms"] = {part: sum(ms for key, ms in by_name.items()
                                 if f"flash_bwd_{part}_kernel" in key)
                       for part in ("delta", "dkdv", "dq")}
    # the kernels run 64 x 64 tiles: 4 products per visible tile pair in
    # dk/dv (S, dP, dv, dk), 3 in dq (S, dP, dq)
    n = -(-T // 64)
    tile_flops = 2 * 64 * 64 * hd * n * (n + 1) // 2 * B * H
    split = row["split_ms"]
    log(f"  backward kernels apart, device ms per call (profiler, 20 calls): "
        f"delta {split['delta']:.4f}, dk/dv {split['dkdv']:.4f} "
        f"({4 * tile_flops / split['dkdv'] / 1e9:.1f} TFLOP/s on its tile "
        f"products), dq {split['dq']:.4f} "
        f"({3 * tile_flops / split['dq'] / 1e9:.1f} TFLOP/s); sum "
        f"{sum(split.values()):.4f}; all kernels of the call "
        f"{sum(by_name.values()):.4f}")
    require(all(ms > 0 for ms in split.values()),
            f"a backward kernel is missing from the trace: {dict(by_name)}")
    fwd = time_flash_fwd(q, k, v, fwd_err)
    log(f"  device time {row['shape']}: backward kernels {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, SDPA backward (fp32, GQA) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); {row['bound_ms'] / row['ms']:.1%} of the "
        f"bound, {flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from Python "
        f"{host_ms(kernel, 5):.4f} ms")
    return row, fwd


def time_flash_fwd(q, k, v, err):
    """The fp32 forward (CUDA cores) beside its bound, its plain version and
    SDPA's forward (fp32, GQA, on inputs that require grad, as in training);
    logs its rate on the tile products and the kernel's occupancy."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    flops = 4 * B * H * hd * (T * (T + 1) // 2)   # visible pairs, causal
    bound = {"operations": flops / PEAK_F32 * 1e3,
             "bytes": 4 * (2 * q.numel() + 2 * k.numel()) / HBM * 1e3}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    row = {
        "max_abs_err": err,
        "ms": device_ms(lambda: flash_attention(q, k, v), 5),
        "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v), 2),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T=S={T} H={H} KV={KV} hd={hd} fp32 causal",
    }
    # the kernel runs 64 x 64 tiles: S and P V per visible tile pair
    n = -(-T // 64)
    row["tile_tflops"] = (2 * 2 * 64 * 64 * hd * n * (n + 1) // 2 * B * H
                          / row["ms"] / 1e9)
    occ = fwd_occupancy(hd)
    log(f"  device time {row['shape']}: forward (fp32, CUDA cores) "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA (fp32, "
        f"GQA) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); kernel / SDPA "
        f"{row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound, "
        f"{row['tile_tflops']:.1f} TFLOP/s on its tile products; "
        f"{occ['smem_bytes']} bytes of shared memory, "
        f"{occ['blocks_per_sm']} block(s) of 16 warps per SM")
    return row


def rmsnorm_bwd_cases(gen):
    """(name, x, g, dy): every training norm's shape, then a view 4 bytes
    off 16-byte alignment (the scalar path)."""
    for rows, d in TRAIN_NORM_SHAPES:
        yield (f"rows={rows} d={d}", randn(gen, rows, d),
               1 + 0.1 * randn(gen, d), randn(gen, rows, d))
    flat = randn(gen, 1000 * 128 + 1)
    yield ("rows=1000 d=128 view at byte offset 4", flat[1:].view(1000, 128),
           1 + 0.1 * randn(gen, 128), randn(gen, 1000, 128))


def check_rmsnorm_bwd(gen):
    path = {}
    for name, x, g, dy in rmsnorm_bwd_cases(gen):
        d = x.shape[-1]
        vec, group, _ = rmsnorm_plan(x.data_ptr() | g.data_ptr()
                                     | dy.data_ptr(), d, 4)
        got = rmsnorm_bwd(x, g, dy, eps=1e-6)
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_(True) for t in (x, g)]
        want = torch.autograd.grad(rmsnorm_ref(*leaves, eps=1e-6), leaves, dy)
        err = check_grads("rmsnorm_bwd", f"{name} fp32 (vec={vec} "
                          f"group={group})", got, want)
        path[name] = time_rmsnorm_bwd(name, x, g, dy, err)
    x = randn(gen, 4, 128, dtype=torch.bfloat16).requires_grad_(True)
    try:
        torch.autograd.grad(rmsnorm(x, torch.ones(128, dtype=torch.bfloat16,
                                                  device="cuda")).sum(), x)
    except NotImplementedError as e:
        log(f"rmsnorm_bwd bf16 on the card raises: {e}")
    else:
        require(False, "a bf16 rmsnorm backward ran on the card")
    return path


def time_rmsnorm_bwd(name, x, g, dy, err):
    rows, d = x.shape
    nbytes = 4 * (3 * rows * d + 2 * d)
    bound = {"operations": 8 * rows * d / PEAK_F32 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    kernel = lambda: rmsnorm_bwd(x, g, dy, eps=1e-6)
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(lambda: rmsnorm_bwd_ref(x, g, dy, eps=1e-6),
                              20),
        "library_ms": grad_device_ms(
            lambda x_, g_: F.rms_norm(x_, (d,), g_, 1e-6), (xl, gl), dy, 50),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"{name} fp32",
    }
    log(f"  device time {name}: backward kernels {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.rms_norm backward "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); {row['bound_ms'] / row['ms']:.1%} of the "
        f"bound, moves {nbytes / row['ms'] / 1e6:.1f} GB/s; one call from "
        f"Python {host_ms(kernel, 50):.4f} ms")
    return row


SSD_GRID = [(1, 128, 4, 1, 16, 32), (2, 256, 2, 2, 8, 64),
            (1, 512, 8, 1, 16, 32)]          # tests/test_kernels.py:124-128
SSD_PATH = (1, 4, 512, 1024)                 # mLSTM: b, H, N=dqk, P=dv
SSD_PATH_T = (137, 1000, 1291)
SLSTM_GRID = [(2, 64, 2, 16), (1, 128, 4, 32),
              (3, 128, 1, 64)]               # tests/test_kernels.py:197-201
SLSTM_PATH = (1, 4, 512)                     # sLSTM: B, nh, dh
SLSTM_PATH_T = (1, 137, 1000)
SLSTM_EXTRA = [(1, 137, torch.float32),      # B, T, r dtype: fp32 r (L2 tail)
               (4, 137, torch.bfloat16)]     # a batch tile of 4 rows


def model_like_ssd(gen, b, T, H, N, P):
    """mLSTM inputs drawn as the served model makes them: log forget gates
    logsigmoid(N(3, 1)) (b_f = 3: slow forgetting, state carried across
    many chunks), input gates w = exp(clamp(N(-2, 1), max=15)), x = v * w,
    B = k / sqrt(N), C = q."""
    a = F.logsigmoid(randn(gen, b, T, H) + 3)
    w = torch.exp(torch.clamp(randn(gen, b, T, H) - 2, max=15))
    x = randn(gen, b, T, H, P) * w[..., None]
    return x, a, randn(gen, b, T, H, N, scale=1 / math.sqrt(N)), \
        randn(gen, b, T, H, N), w


def check_ssd(gen):
    for dtype in (torch.float32, torch.bfloat16):
        for b, T, H, G, N, P in SSD_GRID:
            x = randn(gen, b, T, H, P, dtype=dtype, scale=0.5)
            a = -randn(gen, b, T, H, scale=0.3).abs()
            B, C = (randn(gen, b, T, G, N, dtype=dtype, scale=0.5)
                    .repeat_interleave(H // G, dim=2) for _ in range(2))
            got = ssd_scan(x, a, B, C)
            torch.cuda.synchronize()
            compare("ssd_scan", f"b={b} T={T} H={H} G={G} N={N} P={P} "
                    f"{str(dtype)[6:]}", got, ssd_scan_ref(x, a, B, C))
    path = {}
    b, H, N, P = SSD_PATH
    for T in SSD_PATH_T:
        for init in (False, True):
            x = randn(gen, b, T, H, P, scale=0.5)
            a = -randn(gen, b, T, H, scale=0.3).abs()
            B, C = (randn(gen, b, T, H, N, scale=0.5) for _ in range(2))
            kw = {"norm_weights": torch.exp(randn(gen, b, T, H, scale=0.5) - 2)}
            if init:
                kw["initial_state"] = randn(gen, b, H, N, P)
                kw["initial_norm_state"] = randn(gen, b, H, N)
            got = ssd_scan(x, a, B, C, **kw)
            torch.cuda.synchronize()
            err = compare("ssd_scan", f"b={b} T={T} H={H} N={N} P={P} fp32 "
                          f"normalizer initial_state={init}", got,
                          ssd_scan_ref(x, a, B, C, **kw))
            if not init:
                path[T] = time_ssd(x, a, B, C, kw["norm_weights"], err)
    T = SSD_PATH_T[-1]
    x, a, B, C, w = model_like_ssd(gen, b, T, H, N, P)
    kw = {"norm_weights": w, "initial_state": randn(gen, b, H, N, P),
          "initial_norm_state": randn(gen, b, H, N)}
    got = ssd_scan(x, a, B, C, **kw)
    torch.cuda.synchronize()
    compare("ssd_scan", f"b={b} T={T} H={H} N={N} P={P} fp32 normalizer "
            "initial_state=True, drawn like the model", got,
            ssd_scan_ref(x, a, B, C, **kw))
    return path


def time_ssd(x, a, B, C, w, err):
    b, T, H, P = x.shape
    N = B.shape[-1]
    flops = 4 * b * T * H * N * (P + 1)    # update + output, P columns + n
    nbytes = 4 * (2 * x.numel() + a.numel() + B.numel() + C.numel()
                  + 2 * w.numel() + b * H * N * (P + 1))
    bound = {"operations": flops / PEAK_F32 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    kernel = lambda: ssd_scan(x, a, B, C, norm_weights=w)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 5),
        "plain_ms": device_ms(lambda: ssd_scan_ref(x, a, B, C,
                                                   norm_weights=w), 1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"b={b} T={T} H={H} N={N} P={P} fp32 + normalizer",
    }
    log(f"  device time T={T}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel reaches "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound; one call from "
        f"Python {host_ms(kernel, 5):.4f} ms")
    return row


def slstm_inputs(gen, B, T, nh, dh, dtype, path, r_dtype=torch.bfloat16):
    """Grid inputs as tests/test_kernels.py draws them; path inputs as the
    model's: wx ~ N(0, 1) (rms-normed x through w_in), r ~ N(0, 1/dh) in
    ``r_dtype`` (bf16 weights; fp32 in the fp32-weight check), b = -2 / 3 /
    0 / 0 for the i / f / z / o gates."""
    if not path:
        return (randn(gen, B, T, nh, 4 * dh, dtype=dtype, scale=0.5),
                randn(gen, nh, dh, 4 * dh, scale=0.3),
                randn(gen, nh, 4 * dh, scale=0.2))
    gate_b = torch.tensor([-2.0, 3.0, 0.0, 0.0], device="cuda")
    return (randn(gen, B, T, nh, 4 * dh),
            randn(gen, nh, dh, 4 * dh, dtype=r_dtype,
                  scale=1 / math.sqrt(dh)),
            gate_b.repeat_interleave(dh).expand(nh, 4 * dh).contiguous())


def check_slstm(gen):
    """Every case against the plain version; each path case (the served
    model's shapes) also timed. Returns the path rows by (B, T, r dtype)."""
    bf16 = torch.bfloat16
    cases = [(B, T, nh, dh, dtype, torch.float32, False)
             for dtype in (torch.float32, bf16) for B, T, nh, dh in SLSTM_GRID]
    B1, nh, dh = SLSTM_PATH
    cases += [(B1, T, nh, dh, torch.float32, bf16, True) for T in SLSTM_PATH_T]
    cases += [(B, T, nh, dh, torch.float32, r_dtype, True)
              for B, T, r_dtype in SLSTM_EXTRA]
    for B, r_dtype in [(B1, bf16)] + [(B, r) for B, _, r in SLSTM_EXTRA]:
        plan = slstm_plan(B, nh, dh, r_dtype)
        fit = slstm_max_clusters(B, nh, dh, torch.float32, r_dtype)
        log(f"slstm_scan B={B} nh={nh} dh={dh} r {str(r_dtype)[6:]}: {plan}; "
            f"the card holds {fit} such clusters at once"
            + ("" if fit >= nh else f", so the {nh} heads run in waves"))
    path = {}
    for B, T, nh, dh, dtype, r_dtype, on_path in cases:
        wx, r, b = slstm_inputs(gen, B, T, nh, dh, dtype, on_path, r_dtype)
        hs, state = slstm_scan(wx, r, b)
        torch.cuda.synchronize()
        want_hs, want_state = slstm_scan_ref(wx, r, b)
        err = compare("slstm_scan", f"B={B} T={T} nh={nh} dh={dh} wx "
                      f"{str(wx.dtype)[6:]} r {str(r.dtype)[6:]}",
                      (hs, *state), (want_hs, *want_state))
        if on_path:
            path[B, T, str(r_dtype)[6:]] = time_slstm(wx, r, b, err)
    return path


def time_slstm(wx, r, b, err):
    B, T, nh, gd = wx.shape
    dh = gd // 4
    # the recurrence's multiply-adds, plus ~20 gate operations per unit
    flops = 2 * B * T * nh * dh * gd + 20 * B * T * nh * dh
    nbytes = (wx.numel() * wx.element_size() + r.numel() * r.element_size()
              + 4 * b.numel() + 4 * B * T * nh * dh + 4 * 4 * B * nh * dh)
    bound = {"operations": flops / PEAK_F32 * 1e3,
             "bytes": nbytes / HBM * 1e3}
    kernel = lambda: slstm_scan(wx, r, b)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 3),
        "plain_ms": device_ms(lambda: slstm_scan_ref(wx, r, b), 1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T={T} nh={nh} dh={dh} wx {str(wx.dtype)[6:]} r "
                 f"{str(r.dtype)[6:]}",
    }
    log(f"  device time {row['shape']}: kernel {row['ms']:.4f} ms "
        f"({row['ms'] / T * 1e3:.3f} us per step), plain "
        f"{row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); one call from Python "
        f"{host_ms(kernel, 3):.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 5: serve
# --------------------------------------------------------------------------
@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (reference run
    on the card; the port itself never does this)."""
    saved = ops.attention, ops.norm, ops.ssd, ops.slstm
    ops.attention = lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw)
    ops.norm = lambda x, gain, **kw: rmsnorm_ref(x, gain, **kw)
    ops.ssd = lambda x, a, B, C, **kw: ssd_scan_ref(x, a, B, C, **kw)
    ops.slstm = lambda wx, r, b: slstm_scan_ref(wx, r, b)
    try:
        yield
    finally:
        ops.attention, ops.norm, ops.ssd, ops.slstm = saved


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


def serve(arch: str, n_layers: int, per_prefill: dict, per_step: dict):
    """Serve 8 requests on ``arch`` at full width; require the launch counts
    ``per_prefill`` x prefills + ``per_step`` x decode steps exactly."""
    cfg = get_config(arch)
    require(cfg.n_layers == n_layers and cfg.param_dtype == "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    eng = ServeEngine(cfg, params, slots=4, max_seq=2048, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {arch} full width ({cfg.n_layers} layers "
        f"{dict(Counter(cfg.block_pattern))}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), weights+cache set up in "
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
    want = expected_launches(per_prefill, per_step, st["prefills"],
                             st["decode_steps"])
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
    log(f"serve metrics {arch}: " + json.dumps(metrics))

    check_teacher_forced(params, cfg, prompts[0], done[rids[0]].tokens[:8],
                         per_prefill, per_step)
    profile_serving(eng, prompts[:4])
    return launches, metrics


def expected_launches(per_prefill, per_step, prefills, steps):
    want = Counter({k: v * prefills for k, v in per_prefill.items()})
    want.update({k: v * steps for k, v in per_step.items()})
    return dict(want)


def check_teacher_forced(params, cfg, prompt, forced, per_prefill, per_step):
    """The kernel path's logits against the same model through the plain
    versions on the card, in bf16 and in fp32, and both bf16 paths against
    the fp32 plain run.

    Tolerance: the bf16 noise floor of this run, which is the plain bf16
    path's own distance from fp32. In bf16 the kernel path must be within
    twice that of the plain path and of fp32; in fp32, where both paths see
    the same fp32 activations and differ only in summation order, the
    kernel path must be within the floor itself of the plain path. A wrong
    mask, norm or state moves the logits by far more than rounding does.
    """
    LAUNCHES.clear()
    got = teacher_forced(params, cfg, prompt, forced)
    require(dict(LAUNCHES) == expected_launches(per_prefill, per_step, 1,
                                                len(forced)),
            f"teacher-forced run launched {dict(LAUNCHES)}")
    mid = dict(LAUNCHES)
    params32 = tree_map(lambda t: t.float(), params)
    with plain_versions():
        plain = teacher_forced(params, cfg, prompt, forced)
        ref32 = teacher_forced(params32, cfg, prompt, forced)
    require(dict(LAUNCHES) == mid, "the plain reference launched a kernel")
    got32 = teacher_forced(params32, cfg, prompt, forced)
    del params32
    require(got.shape == (len(forced) + 1, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(got32).all())
    diff = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    to32 = float((got - ref32).abs().max())
    floor = float((plain - ref32).abs().max())
    diff32 = float((got32 - ref32).abs().max())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"teacher-forced logits (prefill + {len(forced)} decode steps, "
        f"prompt {len(prompt)}): kernel vs plain max|diff| {diff:.4e} beside "
        f"max|logit| {scale:.4e} (ratio {diff / scale:.4e}); kernel vs fp32 "
        f"{to32:.4e}; bf16 noise floor (plain vs fp32) {floor:.4e}, tol "
        f"2x that; argmax agreement {agree:.3f}; fp32 weights: kernel vs "
        f"plain {diff32:.4e}, tol the floor")
    require(diff <= 2 * floor, "kernel path disagrees with the plain path")
    require(to32 <= 2 * floor, "kernel path further from fp32 than plain")
    require(diff32 <= floor, "fp32 kernel path disagrees with fp32 plain")


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
    groups = {"flash_attention": 0.0, "rmsnorm": 0.0, "ssd_scan": 0.0,
              "slstm_scan": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "flash_fwd" in name else
                 "rmsnorm" if "rmsnorm_kernel" in name else
                 "ssd_scan" if "ssd_scan" in name else
                 "slstm_scan" if "slstm_scan_kernel" in name else
                 "matmul" if any(w in name for w in ("gemm", "cutlass",
                                                      "xmma", "sm90_"))
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
    cuda_core = [e.key for e in kernels if "flash_fwd_kernel" in e.key]
    require(not cuda_core, f"bf16 serving ran the fp32 flash kernel: {cuda_core}")
    log(f"profile: {len(prompts)} requests x 8 tokens (traced), wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}), {len(kernels)} kernel names; device ms by "
        f"group {json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")


# --------------------------------------------------------------------------
# phase 5b: training, the sweep's member step
# --------------------------------------------------------------------------
TRAIN_LR = 1e-3
TRAIN_STEPS = 8
TRAIN_BATCH = (4, 512)
SWEEP_MEMBERS, SWEEP_STEPS = 16, 5           # launch/sweep.py's defaults
B1, B2, ADAM_EPS, WD = 0.9, 0.95, 1e-8, 0.1  # adamw_update's defaults
LOSS_RTOL = 1e-5      # kernel step vs plain step on the card, fp32
GNORM_RTOL = 1e-4
LEAF_GRAD_TOL = 1e-3  # of each gradient leaf's largest magnitude


def train_launches(n_layers: int) -> dict:
    """One member step's launches: a flash call and its backward per layer,
    ln1, q_norm, k_norm, ln2 per layer and final_norm, each with its
    backward."""
    norms = 4 * n_layers + 1
    return {"flash_attention": n_layers, "flash_attention_bwd": n_layers,
            "rmsnorm": norms, "rmsnorm_bwd": norms}


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from named_leaves(sub, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, f"{prefix}/{i}")
    else:
        yield prefix, tree


def first_step(params, cfg, batch, lr):
    """One member step from fresh moments, in its parts: (loss, grads, grad
    norm); the params are updated in place."""
    loss, grads = loss_and_grads(params, cfg, batch)
    _, _, gnorm = adamw_update(grads, adamw_init(params), params, lr=lr)
    return float(loss), grads, float(gnorm)


def adam_first_step64(g, p, clip, lr):
    """A first AdamW step of one leaf in float64 from zero moments, and the
    magnitude of its terms (the scale of its fp32 rounding)."""
    g, p = g.double() * clip, p.double()
    m, v = (1 - B1) * g, (1 - B2) * g * g
    step = (m / (1 - B1)) / (torch.sqrt(v / (1 - B2)) + ADAM_EPS)
    if p.dim() >= 2:
        step = step + WD * p
    return p - lr * step, p.abs() + lr * step.abs()


def check_train_step_vs_plain(label, cfg, base, batch):
    """One member step with the kernels against the same step through the
    plain versions on the card, from the same params and batch: loss, grad
    norm, every gradient leaf and every updated leaf. The updated leaves are
    held to 1e-6 of their terms plus what the two runs' gradients move a
    first Adam step by (float64): that step is ~g/|g| elementwise, so where
    |g| is within the gradients' agreement its sign is noise and the two
    updates may differ by up to 2 lr."""
    want_launches = train_launches(len(cfg.block_pattern))
    LAUNCHES.clear()
    kernel = clone_tree(base)
    loss_k, grads_k, gn_k = first_step(kernel, cfg, batch, TRAIN_LR)
    torch.cuda.synchronize()
    require(dict(LAUNCHES) == want_launches,
            f"kernel step launched {dict(LAUNCHES)}, not {want_launches}")
    plain = clone_tree(base)
    with plain_versions():
        loss_p, grads_p, gn_p = first_step(plain, cfg, batch, TRAIN_LR)
    require(dict(LAUNCHES) == want_launches,
            "the plain step launched a kernel")
    loss_err, gn_err = abs(loss_k - loss_p) / loss_p, abs(gn_k - gn_p) / gn_p
    grad_err, upd_err, noisy, n = 0.0, 0.0, 0, 0
    clip_k, clip_p = min(1.0, 1.0 / gn_k), min(1.0, 1.0 / gn_p)
    for (path, gk), (_, gp), (_, p0), (_, pk), (_, pp) in zip(
            named_leaves(grads_k), named_leaves(grads_p), named_leaves(base),
            named_leaves(kernel), named_leaves(plain)):
        err = float((gk - gp).abs().max() / gp.abs().max())
        grad_err = max(grad_err, err)
        require(err <= LEAF_GRAD_TOL, f"gradient {path}: {err:.3e} of its max")
        ref_k, terms = adam_first_step64(gk, p0, clip_k, TRAIN_LR)
        ref_p, _ = adam_first_step64(gp, p0, clip_p, TRAIN_LR)
        diff = (pk.detach().double() - pp.detach().double()).abs()
        tol = 1e-6 * terms + (ref_k - ref_p).abs()
        require(bool((diff <= tol).all()),
                f"updated {path} off the plain step")
        upd_err = max(upd_err, float(diff.max()) / TRAIN_LR)
        noisy += int((diff > 1e-3 * TRAIN_LR).sum())
        n += diff.numel()
    log(f"train check {label}, one step kernels vs plain versions: loss "
        f"{loss_k:.6f} "
        f"vs {loss_p:.6f} (rel {loss_err:.2e}, tol {LOSS_RTOL:.0e}); grad "
        f"norm {gn_k:.6f} vs {gn_p:.6f} (rel {gn_err:.2e}, tol "
        f"{GNORM_RTOL:.0e}); worst gradient leaf {grad_err:.2e} of its max "
        f"(tol {LEAF_GRAD_TOL:.0e}); updated leaves within tolerance, largest "
        f"difference {upd_err:.3f} lr, {noisy} of {n} elements differ by more "
        f"than 1e-3 lr (Adam's sign noise where |g| ~ 0)")
    require(loss_err <= LOSS_RTOL,
            "training loss disagrees with the plain run")
    require(gn_err <= GNORM_RTOL, "grad norm disagrees with the plain run")


def profile_train_step(step, params, opt, batch, n_layers):
    """Trace one member step: device busy share and device ms by group. The
    tracer runs through a warm-up step first and records only the second
    step, so no kernel launched while it starts is missed; the log says
    whether the recorded step holds all its flash launches."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, batch, TRAIN_LR)
            float(loss)
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = [e for e in prof.key_averages()    # not the step's own span
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    traced = Counter()    # the fp32 forward and the backward's dq kernel
    for e in kernels:
        for name in ("flash_fwd_kernel<", "flash_bwd_dq_kernel<"):
            if name in e.key:
                traced[name[:-1]] += e.count
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = dict.fromkeys(("flash fwd", "flash bwd", "rmsnorm fwd",
                            "rmsnorm bwd", "matmul", "other"), 0.0)
    for e in kernels:
        name = e.key.lower()
        group = ("flash fwd" if "flash_fwd" in name else
                 "flash bwd" if "flash_bwd" in name else
                 "rmsnorm bwd" if "rmsnorm_bwd" in name else
                 "rmsnorm fwd" if "rmsnorm_kernel" in name else
                 "matmul" if any(w in name for w in ("gemm", "cutlass",
                                                      "xmma", "sm90_"))
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
    require(kernels, "the traced step shows no device time")
    complete = all(traced[k] == n_layers for k in ("flash_fwd_kernel",
                                                   "flash_bwd_dq_kernel"))
    log(f"train profile: traced flash calls {dict(traced)} of {n_layers} "
        f"per step: {'complete' if complete else 'INCOMPLETE'} trace")
    log(f"train profile: one traced step, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), {len(kernels)} kernel names; "
        f"device ms by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    return {"traced_step_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms, "device_ms_by_group": groups}


def train_full_width():
    """qwen3-0.6b at full width in fp32, the sweep member's dtype: the
    kernel step against the plain one, then ``TRAIN_STEPS`` member steps on
    one fixed batch with exact launch counts per step and a falling loss,
    then one traced step. Returns (launches of the steps, metrics)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), param_dtype="float32",
                              remat="none")
    require(cfg.block_pattern == ("attn",) * QWEN_LAYERS
            and cfg.head_dim == 128)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    n_params = sum(t.numel() for _, t in named_leaves(params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = to_batch({"tokens": tokens, "labels": tokens}, "cuda")
    log(f"train: {cfg.name} full width ({cfg.n_layers} ATTN layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, tied), fp32 params from "
        f"seed 0: {n_params / 1e6:.1f} M ({n_params * 4 / 2**30:.2f} GiB); "
        f"batch {TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}, lr {TRAIN_LR}; TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = False), so the fp32 GEMMs "
        "run in full fp32 as the CPU parity holds them")
    check_train_step_vs_plain("qwen3-0.6b full width", cfg, params, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = build_member_step(cfg, device="cuda")
    opt = adamw_init(params)
    want = train_launches(cfg.n_layers)
    losses, step_ms, launches = [], [], Counter()
    for i in range(TRAIN_STEPS):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, TRAIN_LR)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        require(dict(LAUNCHES) == want,
                f"step {i} launched {dict(LAUNCHES)}, not {want}")
        launches.update(LAUNCHES)
        log(f"train step {i}: loss {losses[-1]:.6f}, {step_ms[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(x) for x in losses), "non-finite training loss")
    require(losses[-1] < 0.9 * losses[0],
            f"loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    metrics = {"loss_first": losses[0], "loss_last": losses[-1],
               "step_ms_median": float(np.median(step_ms[1:])),
               "step_ms": step_ms, "peak_mem_gib": peak,
               "launches_per_step": want}
    log("train metrics qwen3-0.6b fp32 full width: " + json.dumps(metrics))
    metrics.update(profile_train_step(step, params, opt, batch, cfg.n_layers))
    return dict(launches), metrics


SERVE_TRAINED_TICKS = 20


def check_serving_trained(cfg, params, device="cuda"):
    """Serve params straight from training (2 slots, prompts of 9 and 23
    tokens, 40 new tokens each, ``SERVE_TRAINED_TICKS`` ticks): no param
    leaf requires grad, no cache leaf has a ``grad_fn`` (the engine records
    no graph), and the tokens equal an engine's on a detached copy."""
    require(not any(t.requires_grad for t in tree_leaves(params)),
            "a param leaf requires grad after a member step")

    def run(p):
        eng = ServeEngine(cfg, p, slots=2, max_seq=128, device=device)
        rng = np.random.default_rng(0)
        for n in (9, 23):
            eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=40)
        reqs = list(eng.queue)
        for _ in range(SERVE_TRAINED_TICKS):
            eng.tick()
        return [list(r.tokens) for r in reqs], eng.cache

    tokens, cache = run(params)
    leaves = tree_leaves(cache)
    graphs = sum(t.grad_fn is not None or t.requires_grad for t in leaves)
    want, _ = run(clone_tree(params))
    log(f"serve after training: {SERVE_TRAINED_TICKS} ticks, "
        f"{sum(map(len, tokens))} tokens; {graphs} of {len(leaves)} cache "
        f"leaves carry autograd state; tokens "
        f"{'equal' if tokens == want else 'DIFFER from'} those of an engine "
        "on a detached copy")
    require(graphs == 0, "serving trained params recorded an autograd graph")
    require(tokens == want, "serving trained params changed the tokens")


def train_sweep():
    """The sweep's own member (``member_config``: 4 ATTN layers, hd 32,
    vocab 256, fp32): ``SWEEP_MEMBERS`` members of ``SWEEP_STEPS`` steps on
    ``SyntheticLM`` batches at the sweep's learning rates, one after another
    in-process, each from the same base params, after one member step with
    the kernels is held against the same step through the plain versions.
    Returns (launches, metrics)."""
    cfg = member_config("qwen3-0.6b")
    require(cfg.block_pattern == ("attn",) * 4 and cfg.head_dim == 32)
    base = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                       device="cuda")
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    batches = [to_batch(src.batch(i), "cuda") for i in range(SWEEP_STEPS)]
    check_train_step_vs_plain("sweep member", cfg, base, batches[0])
    step = build_member_step(cfg, device="cuda")
    lrs = np.geomspace(1e-4, 3e-2, SWEEP_MEMBERS)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    finals = []
    for lr in lrs:
        params = clone_tree(base)
        opt = adamw_init(params)
        for batch in batches:
            params, opt, loss = step(params, opt, batch, float(lr))
        finals.append(float(loss))
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: v * SWEEP_MEMBERS * SWEEP_STEPS
            for k, v in train_launches(len(cfg.block_pattern)).items()}
    log(f"sweep: {SWEEP_MEMBERS} members x {SWEEP_STEPS} steps of "
        f"{cfg.name} (4 ATTN layers, d_model {cfg.d_model}, hd "
        f"{cfg.head_dim}, fp32) in {wall:.2f} s "
        f"({wall / (SWEEP_MEMBERS * SWEEP_STEPS) * 1e3:.2f} ms per step); "
        f"launches {launches} (expected {want})")
    log("sweep final losses by lr: " + ", ".join(
        f"{lr:.2e}: {x:.4f}" for lr, x in zip(lrs, finals)))
    require(launches == want, f"sweep launch counts {launches} != {want}")
    require(all(math.isfinite(x) for x in finals), "a member's loss is not "
            "finite")
    require(min(finals) < math.log(cfg.vocab_size),
            "no member's loss fell below the uniform guess")
    check_serving_trained(cfg, params)
    return launches, {"members": SWEEP_MEMBERS, "steps": SWEEP_STEPS,
                      "wall_s": wall, "final_losses": finals}


# --------------------------------------------------------------------------
# phase 5c: the sweep's command line (preposition, supervisor, task array)
# --------------------------------------------------------------------------
SWEEP_CLI_TIMEOUT = 300         # seconds; the CLI takes well under a minute
FULL_GRID = ({"lr": 1e-3}, {"lr": 1e-3}, {"lr": 3e-4})
FULL_STEPS = 3
SWEEP_LOSS_RTOL = 1e-6


def sweep_cli():
    """``python -m repro_torch.launch.sweep`` as a user runs it (qwen3-0.6b,
    16 members x 5 steps on the card), in a fresh process that finds the
    kernels' library phase 2 built. Returns its metrics."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.sweep"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=SWEEP_CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"  cli| {line}")
    require(proc.returncode == 0, f"the sweep CLI exited {proc.returncode}")
    want = f"launched {SWEEP_MEMBERS}/{SWEEP_MEMBERS} members"
    require(want in proc.stdout, f"the sweep CLI did not print {want!r}")
    prep = re.search(r"prepositioned in ([0-9.]+)s", proc.stdout)
    rate = re.search(r"members x \d+ steps in ([0-9.]+)s \(([0-9.]+)/s",
                     proc.stdout)
    require(prep and rate, "the sweep CLI's lines did not parse")
    metrics = {"process_wall_s": wall,
               "prepositioned_s": float(prep.group(1)),
               "sweep_s": float(rate.group(1)),
               "members_per_s": float(rate.group(2))}
    log("sweep cli metrics: " + json.dumps(metrics))
    return metrics


def sweep_in_process(want_finals):
    """``run_sweep`` with the CLI's defaults in this process: the warm cache
    holds one entry hit once per member, the array runs 16 of 16, the
    launches are exactly one warm step and 80 member steps, the
    prepositioned params come out as they went in, and the final losses are
    ``train_sweep``'s (same seed, batches and kernels). Returns (launches,
    metrics)."""
    cfg = member_config("qwen3-0.6b")
    LAUNCHES.clear()
    run = run_sweep(cfg, SWEEP_MEMBERS, SWEEP_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    sup, arr = run.supervisor, run.result["sweep"]
    stats = dict(sup.warmer.stats)
    devices = sup.devices[:1]                 # run_sweep's member devices
    entry = sup.warmer.get(cfg, SHAPES["train_4k"], devices)
    want = {k: v * (1 + SWEEP_MEMBERS * SWEEP_STEPS)
            for k, v in train_launches(len(cfg.block_pattern)).items()}
    finals = [m["loss"] for m in run.members]
    errs = [abs(a - b) / abs(b) for a, b in zip(finals, want_finals)]
    base = sup.weights.get(cfg, devices, 0)
    fresh = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(base), tree_leaves(fresh)))
    launch_ms = [1e3 * m["launch_s"] for m in run.members]
    metrics = {"members": SWEEP_MEMBERS, "steps": SWEEP_STEPS,
               "preposition_s": run.preposition_s,
               "build_s": entry.build_s, "first_step_s": entry.first_step_s,
               "sweep_s": run.wall_s,
               "members_per_s": SWEEP_MEMBERS / run.wall_s,
               "member_step_ms": run.wall_s / (SWEEP_MEMBERS * SWEEP_STEPS)
               * 1e3,
               "launch_ms": launch_ms, "report": sup.launch_report()}
    log(f"sweep in process: {arr.summary}; warm cache {stats}; launches "
        f"{launches} (expected {want}); base params "
        f"{'unchanged' if unchanged else 'CHANGED'}; final losses vs "
        f"train_sweep's: worst rel {max(errs):.2e} (tol "
        f"{SWEEP_LOSS_RTOL:.0e}), "
        f"{'bit-equal' if finals == want_finals else 'not bit-equal'}")
    log("sweep in process metrics: " + json.dumps(metrics))
    require(stats == {"warms": 1, "hits": SWEEP_MEMBERS, "misses": 0},
            f"warm cache stats {stats}")
    require(arr.summary.ok == SWEEP_MEMBERS and arr.summary.failed == 0,
            f"sweep array {arr.summary}")
    require(launches == want, f"sweep launch counts {launches} != {want}")
    require(unchanged, "the sweep changed the prepositioned params")
    require(max(errs) <= SWEEP_LOSS_RTOL,
            "the in-process sweep's losses differ from train_sweep's")
    return launches, metrics


def sweep_full_width(step0_loss):
    """The supervisor at full width: qwen3-0.6b fp32, 28 layers, seed-0
    params and phase 5b's fixed batch, prepositioned through the warm cache,
    then 3 members of 3 steps launched one at a time under the default quota
    of one card, each from its own clone. Returns (launches, metrics)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), param_dtype="float32",
                              remat="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               TRAIN_BATCH)
    batch = to_batch({"tokens": tokens, "labels": tokens}, "cuda")
    shape = SHAPES["train_4k"]
    sup = SweepSupervisor()
    devices = sup.devices[:1]

    def seeded(seed):
        return init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                           device="cuda")

    def build():
        def make_args():
            params = seeded(1)
            return params, adamw_init(params), batch, TRAIN_LR
        return build_member_step(cfg, device="cuda"), make_args

    LAUNCHES.clear()
    t0 = time.perf_counter()
    entry = sup.preposition(cfg, shape, devices, build,
                            init=lambda: seeded(0))
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    base = sup.weights.get(cfg, devices, 0)

    def run_member(entry, member):
        params = tree_map(torch.clone, base)
        opt = adamw_init(params)
        losses, ms = [], []
        for _ in range(FULL_STEPS):
            t = time.perf_counter()
            params, opt, loss = entry.step(params, opt, batch,
                                           member.hparams["lr"])
            losses.append(float(loss))
            ms.append((time.perf_counter() - t) * 1e3)
        return {"losses": losses, "step_ms": ms}

    members = []
    for hp in FULL_GRID:
        [m] = sup.launch_sweep(cfg, shape, devices, [hp], run_member)
        require(m.state == "running", f"full-width member {m.mid} {m.state}:"
                f" {m.result}")
        sup.release(m)
        members.append(m)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {k: v * (1 + len(FULL_GRID) * FULL_STEPS)
            for k, v in train_launches(cfg.n_layers).items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in members:
        log(f"full-width member {m.mid} lr {m.hparams['lr']:.0e}: losses "
            f"{m.result['losses']}, step ms "
            f"{[round(x, 1) for x in m.result['step_ms']]}, launch "
            f"{1e3 * m.launch_time:.1f} ms")
    first_errs = [abs(m.result["losses"][0] - step0_loss) / step0_loss
                  for m in members]
    metrics = {"preposition_s": prep_s, "build_s": entry.build_s,
               "first_step_s": entry.first_step_s,
               "launch_ms": [1e3 * m.launch_time for m in members],
               "step_ms": [m.result["step_ms"] for m in members],
               "peak_mem_gib": peak, "warm_cache": dict(sup.warmer.stats),
               "first_loss_rel_err": max(first_errs)}
    log(f"sweep full width: launches {launches} (expected {want}); step-0 "
        f"loss of phase 5b {step0_loss:.6f}; " + json.dumps(metrics))
    require(sup.warmer.stats["hits"] == len(FULL_GRID),
            f"warm cache stats {sup.warmer.stats}")
    require(launches == want, f"full-width launch counts {launches} != "
            f"{want}")
    require(members[0].result["losses"] == members[1].result["losses"],
            "two members at one lr from one base trained differently")
    require(max(first_errs) <= SWEEP_LOSS_RTOL,
            "a member's first loss is not phase 5b's step-0 loss")
    require(all(math.isfinite(x) for m in members
                for x in m.result["losses"]), "non-finite loss")
    return launches, metrics


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
        if any(w in line for w in ("registers", "spill", "Compiling", "smem")):
            log(f"  {line.strip()}")
    log("flash_fwd_sm90_kernel dynamic shared memory per block: " + ", ".join(
        f"hd={hd} {sm90_smem_bytes(hd)} bytes" for hd in (32, 64, 128)))
    for hd in (32, 64, 128):
        fwd_occ = fwd_occupancy(hd)
        log(f"flash_attention_fwd hd={hd}: {fwd_occ['smem_bytes']} bytes of "
            f"shared memory, {fwd_occ['blocks_per_sm']} block(s) of 16 warps "
            f"per SM")
        require(fwd_occ["blocks_per_sm"] >= 1,
                f"the fp32 flash forward does not fit an SM at hd={hd}")
        occ = bwd_occupancy(hd)
        log(f"flash_attention_bwd hd={hd}: dk/dv kernel "
            f"{occ['dkdv_smem_bytes']} bytes of shared memory, "
            f"{occ['dkdv_blocks_per_sm']} block(s) of 16 warps per SM; dq "
            f"kernel {occ['dq_smem_bytes']} bytes, "
            f"{occ['dq_blocks_per_sm']} block(s) per SM")
        require(min(occ["dkdv_blocks_per_sm"], occ["dq_blocks_per_sm"]) >= 1,
                f"a flash backward kernel does not fit an SM at hd={hd}")

    check_splitk(torch.Generator("cuda").manual_seed(1))    # phase 3

    gen = torch.Generator("cuda").manual_seed(0)             # phase 4
    flash_rows = check_flash(gen)
    rms_rows = check_rmsnorm(gen)
    flash_bwd_row, flash_fp32_row = check_flash_bwd(gen)
    rms_bwd_rows = check_rmsnorm_bwd(gen)
    ssd_rows = check_ssd(gen)
    slstm_rows = check_slstm(gen)

    qwen, _ = serve("qwen3-0.6b", QWEN_LAYERS,                # phase 5
                    {"flash_attention": QWEN_LAYERS, "rmsnorm": QWEN_NORMS},
                    {"rmsnorm": QWEN_NORMS})
    xlstm, _ = serve("xlstm-1.3b", XLSTM_MLSTM + XLSTM_SLSTM,
                     {"ssd_scan": XLSTM_MLSTM, "slstm_scan": XLSTM_SLSTM,
                      "rmsnorm": XLSTM_NORMS},
                     {"rmsnorm": XLSTM_NORMS})
    train, train_metrics = train_full_width()                # phase 5b
    sweep, sweep_metrics = train_sweep()
    torch.cuda.empty_cache()

    sweep_cli()                                              # phase 5c
    cli, _ = sweep_in_process(sweep_metrics["final_losses"])
    full, _ = sweep_full_width(train_metrics["loss_first"])

    serving = {"qwen3-0.6b serve": qwen, "xlstm-1.3b serve": xlstm}
    training = {"qwen3-0.6b train (fp32, full width)": train,
                "sweep member (qwen3-0.6b reduced, fp32)": sweep,
                "sweep CLI run_sweep (qwen3-0.6b reduced, fp32)": cli,
                "sweep supervisor (qwen3-0.6b fp32, full width)": full}

    def launches(name, paths):                               # phase 6
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    csrc = "src/repro_torch/kernels/csrc/"
    flash_tpu = "src/repro/kernels/flash_attention.py:121"
    rms_tpu = "src/repro/kernels/rmsnorm.py:35"
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention_sm90.cu", "replaces": flash_tpu,
         **launches("flash_attention", serving), **flash_rows[REPORT_T]},
        {"name": "flash_attention_fp32", "route": "cuda",
         "source": csrc + "flash_attention.cu", "replaces": flash_tpu,
         **launches("flash_attention", training), **flash_fp32_row},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu", "replaces": flash_tpu,
         **launches("flash_attention_bwd", training), **flash_bwd_row},
        {"name": "rmsnorm", "route": "cuda", "source": csrc + "rmsnorm.cu",
         "replaces": rms_tpu, **launches("rmsnorm", {**serving, **training}),
         **rms_rows[REPORT_RMS]},
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": csrc + "rmsnorm_bwd.cu", "replaces": rms_tpu,
         **launches("rmsnorm_bwd", training),
         **rms_bwd_rows[RMS_BWD_REPORT]},
        {"name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:82",
         **launches("ssd_scan", serving), **ssd_rows[REPORT_T]},
        {"name": "slstm_scan", "route": "cuda",
         "source": csrc + "slstm_scan.cu",
         "replaces": "src/repro/kernels/slstm_scan.py:94",
         **launches("slstm_scan", serving),
         **slstm_rows[1, REPORT_T, "bfloat16"]},
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never ran on its paths")
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                 "bound_ms")))
        require(k["library_ms"] is None or math.isfinite(k["library_ms"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

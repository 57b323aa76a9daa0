#!/usr/bin/env python3
"""A/B of the PyTorch port against an older checkout, on one CUDA card.

    git archive <rev> | tar -x -C build/parent     # build/ is gitignored
    python3 scripts/port_ab.py --parent build/parent
    python3 scripts/port_ab.py --parent build/parent --only rmsnorm
    python3 scripts/port_ab.py --parent build/parent --only ssd_bwd
    python3 scripts/port_ab.py --parent build/parent --only slstm_bwd
    python3 scripts/port_ab.py --parent build/parent --only ssd,serve \
        --arch zamba2-2.7b

Comparisons (``--only`` picks some of flash, ssd, ssd_bwd, slstm_bwd,
rmsnorm and serve; all by default), each in the order parent, this checkout, this checkout, parent,
so that a drift of the card or the host shows as a spread:

- ``flash_attention_fwd`` (the fp32 forward, with lse) and
  ``flash_attention_bwd`` at the member step's shape (B=4 T=S=512 H=16
  KV=8 hd=128, fp32, causal), then the backward in bf16 at that shape and
  at zamba2's Trainer shape (B=4 T=S=512 H=KV=32 hd=80), then the bf16
  forward (``flash_attention_sm90_fwd``, no lse, as serving calls it) at
  B=1 T=S=1000 H=16 KV=8 hd=128 and at nemotron's B=1 T=S=1000 H=96 KV=8
  hd=192: the parent's ``csrc/flash_attention.cu``,
  ``csrc/flash_attention_bwd.cu`` (or ``_bwd_sm90.cu``) and
  ``csrc/flash_attention_sm90.cu`` are each built alone into a library of
  their own under ``build/ab/`` and called through the C entry of the
  dtype (``flash_attention_bwd_bf16`` for bf16), this checkout's through
  its wrapper; device ms per call from CUDA-graph replay
  (``chip_smoke.device_ms``), whether the two give the same bits, and
  their largest difference; the bf16 backward's rows also split by kernel
  (delta, dk/dv, dq) with the profiler.
- ``ssd_scan_fwd`` (the parent's C entry, built alone as above, B and C
  expanded to every head as the parent's callers handed them) against
  this checkout's ``ssd_scan`` on the same inputs with B and C as its
  callers hand them now: zamba2's Mamba-2 shape (b=1 H=80 N=P=64, one
  group, ``chip_smoke.mamba2_like_ssd``) at T = 137 / 1000 / 1291, where
  the parent's time is also given with the expansion its caller paid
  (``repeat_interleave`` to 80 heads), and the mLSTM shape (b=1 T=1000 H=4
  N=512 P=1024 fp32 with the normalizer, G = H), whose bits must not
  change.
- ``ssd_scan_bwd`` at the Trainer's two shapes (``chip_smoke.SSD_BWD_TRAIN``:
  zamba2's b=4 T=512 H=80 G=1 N=P=64 and xlstm's mLSTM b=4 T=512 H=G=4
  N=512 P=1024 with the normalizer), on ``chip_smoke.ssd_bwd_inputs``'s
  draws: the parent's ``csrc/ssd_scan_bwd.cu`` built alone as above and
  called through its C entry (x and dy copied to Pe = P (+ 1) columns in
  the call, as the parent's wrapper did), against this checkout's
  ``ssd_scan_bwd``;
  ms per call, each kernel's ms with the products' TFLOP/s and the pass's
  GB/s (``chip_smoke.ssd_bwd_split``), and which of dx, da, dB, dC (and dw)
  have the parent's bits.
- ``slstm_scan_bwd`` at the Trainer's microbatch (``chip_smoke.SLSTM_BWD_TRAIN``:
  xlstm's B=4 T=512 nh=4 dh=512, wx fp32, r in bf16 and in fp32, drawn as
  ``chip_smoke.slstm_inputs``), through the forward's trace: the parent's
  ``csrc/slstm_scan_bwd.cu`` built alone as above and called through its C
  entry with its wrapper's carry and dR product, against this checkout's
  ``slstm_scan_bwd``; ms per call, the largest difference of dwx, dr and
  db between the two, and each one's error against the plain backward
  (``slstm_scan_bwd_ref``) relative to each gradient's largest magnitude:
  the order of the recurrent sum may differ between the two, so the gate
  is ``chip_smoke.GRAD_TOL`` against the plain backward (dr from bf16 r
  within a bf16 rounding), not the parent's bits.
- The rmsnorm backward at the Trainer's three norm shapes (2048x1024:
  ln1, ln2, final_norm; 32768x128: q_norm; 16384x128: k_norm, all at
  B·T = 2048): the parent's ``csrc/rmsnorm_bwd.cu`` built alone as above
  and called through its C entry ``rmsnorm_bwd`` (with this checkout's
  ``plan`` and ``bwd_blocks``, which the parent shares), against this
  checkout's ``rmsnorm_bwd``; bf16 device ms with ``F.rms_norm``'s bf16
  backward beside them, and in fp32 whether the two give the same bits.
- Serving ``--arch`` (qwen3-0.6b by default) at full width (bf16 weights
  from seed 0, 4 slots, 8 requests of 32 new tokens, ``chip_smoke.py``'s
  prompts), one process per run, each serving twice and reporting the
  second: prefill ms per request, decode ms per step and tokens/s on the
  host clock.

Prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
SHAPE = (4, 512, 16, 8, 128)                 # B, T=S, H, KV, hd
BWD80 = (4, 512, 32, 32, 80)                 # zamba2's Trainer microbatch
FWD_SM90 = ((1, 1000, 16, 8, 128),           # qwen3-0.6b's prefill
            (1, 1000, 96, 8, 192))           # nemotron's prefill


def serve(tree: Path, arch: str) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch)
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
    return {"serve": str(tree), "arch": arch,
            "tokens_per_s": 32 * len(prompts) / wall,
            "prefill_ms": st["prefill_s"] / st["prefills"] * 1e3,
            "decode_ms": st["decode_s"] / st["decode_steps"] * 1e3}


@functools.cache
def parent_library(parent: Path, source: str) -> ctypes.CDLL:
    """The parent's ``source`` built alone into its own library (nvcc with
    this checkout's flags), once per process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    lib = ROOT / "build" / "ab" / f"parent_{Path(source).stem}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cs.build.nvcc(), *cs.build.NVCC_FLAGS, "-shared", "-I",
                    str(parent / CSRC), "-o", str(lib),
                    str(parent / CSRC / source)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def parent_entry(parent: Path, source: str, entry: str, argtypes):
    """``entry`` of the parent's ``source``."""
    fn = getattr(parent_library(parent, source), entry)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without its template and arguments."""
    found = re.search(r"flash_\w*kernel\w*", key)
    return found.group(0) if found else key[:40]


def ab_rows(kernel: str, parent_call, this_call, dtype="fp32",
            shape=SHAPE, split=False) -> list:
    """Rows of parent, this, this, parent; with ``split``, each row also
    gives every kernel's device ms per call (``chip_smoke.device_ms_by_kernel``,
    the profiler) under ``split_ms``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    pairs = list(zip(parent_call(), this_call()))
    same = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    B, T, H, KV, hd = shape
    shape = f"B={B} T=S={T} H={H} KV={KV} hd={hd} {dtype} causal"
    rows = []
    for name, fn in (("parent", parent_call), ("this", this_call),
                     ("this", this_call), ("parent", parent_call)):
        row = {kernel: name, "shape": shape, "ms": cs.device_ms(fn, 10),
               "same_bits_as_parent": same, "max_abs_diff": diff}
        if split:
            row["split_ms"] = {kernel_name(k): round(v, 4) for k, v in
                               cs.device_ms_by_kernel(fn, 20).items()}
        rows.append(row)
    return rows


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


FLASH_SCALARS = (ctypes.c_int,) * 9 + (ctypes.c_float, ctypes.c_void_p)


def flash_parent_entry(parent: Path, source: str, entry: str):
    """(``entry`` of the parent's flash ``source``, whether it takes the
    output's rounding residual o_lo): its pointers counted from its own
    signature, before the scalars every flash entry ends with."""
    text = (parent / CSRC / source).read_text()
    sig = text[text.index(f'extern "C" int {entry}('):]
    sig = sig[:sig.index(")")]
    pointers = sig.count(",") + 1 - len(FLASH_SCALARS)
    return (parent_entry(parent, source, entry,
                         (ctypes.c_void_p,) * pointers + FLASH_SCALARS),
            "o_lo" in sig)


def flash_sm90_fwd(parent: Path, shape) -> list:
    """The bf16 forward without lse: the parent's C entry against this
    checkout's wrapper."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    entry = "flash_attention_sm90_fwd"
    old, residual = flash_parent_entry(parent, "flash_attention_sm90.cu",
                                       entry)
    B, T, H, KV, hd = shape
    gen = torch.Generator("cuda").manual_seed(0)
    q = cs.randn(gen, B, T, H, hd, dtype=torch.bfloat16)
    k, v = (cs.randn(gen, B, T, KV, hd, dtype=torch.bfloat16)
            for _ in range(2))

    def parent_call():
        o = torch.empty_like(q)
        code = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   *(None,) * (1 + residual), B, T, T, H, KV, hd, 1, 0, 0,
                   1.0 / math.sqrt(hd),
                   torch.cuda.current_stream().cuda_stream)
        cs.build.check(code, "parent flash_attention_sm90_fwd")
        return (o,)

    this_call = lambda: (fa.flash_attention(q, k, v),)
    return ab_rows(entry, parent_call, this_call, "bf16", shape)


def flash_bwd(parent: Path, dtype: str = "fp32", shape=SHAPE) -> list:
    """``dtype`` "fp32" or "bf16": the parent's C entry for that dtype (in
    its ``flash_attention_bwd_sm90.cu`` where it has one) against this
    checkout's backward, called as training calls it: in bf16 with the plain
    forward's rounding residual o_lo, which a parent that takes one is
    handed too (an older parent's D reads o alone, so its bits differ)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    entry = {"fp32": "flash_attention_bwd", "bf16": "flash_attention_bwd_bf16"}
    source = "flash_attention_bwd_sm90.cu"  # the bf16 entry, in newer trees
    if dtype == "fp32" or not (parent / CSRC / source).exists():
        source = "flash_attention_bwd.cu"
    old, residual = flash_parent_entry(parent, source, entry[dtype])
    B, T, H, KV, hd = shape
    gen = torch.Generator("cuda").manual_seed(0)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, do = (cs.randn(gen, B, T, H, hd, dtype=tdt) for _ in range(2))
    k, v = (cs.randn(gen, B, T, KV, hd, dtype=tdt) for _ in range(2))
    o, lse, o_lo = cs.flash_attention_ref(q, k, v, with_lse=True,
                                          with_residual=True)
    o = o.contiguous()
    o_lo = o_lo.contiguous() if dtype == "bf16" else None   # as training

    def parent_call():
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        lo = (None if o_lo is None else o_lo.data_ptr(),) * residual
        code = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   *lo, lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(),
                   torch.empty_like(lse).data_ptr(), B, T, T, H, KV, hd, 1, 0,
                   0, 1.0 / math.sqrt(hd),
                   torch.cuda.current_stream().cuda_stream)
        cs.build.check(code, "parent flash_attention_bwd")
        return dq, dk, dv

    this_call = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo)
    return ab_rows("flash_attention_bwd", parent_call, this_call, dtype,
                   shape, split=dtype == "bf16")


SSD_MAMBA = (1, 80, 64, 64)                  # b, H, N, P (zamba2)
SSD_MAMBA_T = (137, 1000, 1291)
SSD_MLSTM = (1, 1000, 4, 512, 1024)          # b, T, H, N, P (xlstm)
SSD_PARENT_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p,)


def ssd(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    old = parent_entry(parent, "ssd_scan.cu", "ssd_scan_fwd",
                       SSD_PARENT_ARGTYPES)
    gen = torch.Generator("cuda").manual_seed(0)

    def parent_call(x, a, B, C, w=None):
        """The parent's C entry; B and C [b,T,H,N] (expanded)."""
        b, T, H, P = x.shape
        N = B.shape[-1]
        y, S = torch.empty_like(x), torch.empty(b, H, N, P, device="cuda")
        n = torch.empty(b, T, H, device="cuda") if w is not None else None
        Sn = torch.empty(b, H, N, device="cuda") if w is not None else None
        ws = torch.empty(b * H * -(-T // 64) * 64 * 66, device="cuda")
        ptr = lambda t: None if t is None else t.data_ptr()
        code = old(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                   None, y.data_ptr(), S.data_ptr(), ptr(w), None, ptr(n),
                   ptr(Sn), ws.data_ptr(), 0, b, T, H, N, P,
                   torch.cuda.current_stream().cuda_stream)
        cs.build.check(code, "parent ssd_scan_fwd")
        return (y, S) if w is None else (y, n, S, Sn)

    def rows(shape, pairs, same_bits):
        out = []
        for name, fn in pairs:
            out.append({"ssd_scan": name, "shape": shape,
                        "ms": cs.device_ms(fn, 5), **same_bits})
        return out

    result = []
    b, H, N, P = SSD_MAMBA
    for T in SSD_MAMBA_T:
        x, a, B, C = cs.mamba2_like_ssd(gen, b, T, H, N, P)   # B, C per group
        expand = lambda: [t.repeat_interleave(H, dim=2).float()
                          for t in (B, C)]
        Be, Ce = expand()
        this = lambda: cs.ssd_scan(x, a, B, C)
        par = lambda: parent_call(x, a, Be, Ce)
        par_expand = lambda: parent_call(x, a, *expand())
        diff = max(float((p - t).abs().max()) for p, t in zip(par(), this()))
        shape = f"b={b} T={T} H={H} G=1 N={N} P={P} fp32"
        result += rows(shape, [("parent", par), ("this", this),
                               ("this", this), ("parent", par),
                               ("parent + expansion", par_expand)],
                       {"max_abs_diff_vs_parent": diff})
    b, T, H, N, P = SSD_MLSTM
    x = cs.randn(gen, b, T, H, P, scale=0.5)
    a = -cs.randn(gen, b, T, H, scale=0.3).abs()
    B, C = (cs.randn(gen, b, T, H, N, scale=0.5) for _ in range(2))
    w = torch.exp(cs.randn(gen, b, T, H, scale=0.5) - 2)
    this = lambda: cs.ssd_scan(x, a, B, C, norm_weights=w)
    par = lambda: parent_call(x, a, B, C, w)
    same = all(torch.equal(p, t) for p, t in zip(par(), this()))
    result += rows(f"b={b} T={T} H={H} G={H} N={N} P={P} fp32 + normalizer",
                   [("parent", par), ("this", this), ("this", this),
                    ("parent", par)], {"same_bits_as_parent": same})
    return result


def ssd_bwd(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")
    old = parent_entry(parent, "ssd_scan_bwd.cu", "ssd_scan_bwd",
                       ssd_module._BWD_ARGTYPES)
    old_ws = parent_entry(parent, "ssd_scan_bwd.cu", "ssd_scan_bwd_workspace",
                          ssd_module._BWD_WS_ARGTYPES)
    gen = torch.Generator("cuda").manual_seed(0)
    result = []
    for draw, (b, T, H, G, N, P) in cs.SSD_BWD_TRAIN.items():
        norm = draw == "mlstm"
        x, a, B, C, w, dy, dn = cs.ssd_bwd_inputs(gen, b, T, H, G, N, P, norm,
                                                  draw)
        Pe = P + norm
        cat = lambda m, e: (torch.cat([m, e[..., None]], -1) if norm
                            else m).contiguous()
        size = ctypes.c_longlong(0)
        cs.build.check(old_ws(b, T, H, G, N, Pe, ctypes.addressof(size)),
                       "parent ssd_scan_bwd_workspace")

        def parent_call():             # with its wrapper's copies of x, dy
            xe, dye = cat(x, w), cat(dy, dn)
            ws = torch.empty(size.value, device="cuda")
            dxe = torch.empty(b, T, H, Pe, device="cuda")
            da = torch.empty(b, T, H, device="cuda")
            dB, dC = (torch.empty(b, T, G, N, device="cuda")
                      for _ in range(2))
            dBh, dCh = ((dB, dC) if G == H else
                        (torch.empty(b, T, H, N, device="cuda")
                         for _ in range(2)))
            code = old(xe.data_ptr(), a.data_ptr(), B.data_ptr(),
                       C.data_ptr(), dye.data_ptr(), None, None,
                       ws.data_ptr(), dxe.data_ptr(), da.data_ptr(),
                       dBh.data_ptr(), dCh.data_ptr(), dB.data_ptr(),
                       dC.data_ptr(), b, T, H, G, N, Pe,
                       torch.cuda.current_stream().cuda_stream)
            cs.build.check(code, "parent ssd_scan_bwd")
            return (dxe[..., :P], da, dB, dC) + ((dxe[..., P],) if norm
                                                 else ())

        this_call = lambda: tuple(
            t for t in cs.ssd_scan_bwd(x, a, B, C, dy, norm_weights=w, dn=dn)
            if t is not None)
        names = ("dx", "da", "dB", "dC", "dw")
        same = {n: torch.equal(p_, t_) for n, p_, t_
                in zip(names, parent_call(), this_call())}
        again = all(torch.equal(p_, t_) for p_, t_
                    in zip(this_call(), this_call()))
        work = cs.work.ssd_bwd_products(b, T, H, G, N, Pe)
        shape = (f"b={b} T={T} H={H} G={G} N={N} P={P} fp32"
                 + (" + normalizer" if norm else ""))
        for name, fn in (("parent", parent_call), ("this", this_call),
                         ("this", this_call), ("parent", parent_call)):
            split_ms, split = cs.ssd_bwd_split(fn, work)
            result.append({"ssd_scan_bwd": name, "shape": shape,
                           "ms": cs.device_ms(fn, 5),
                           "split_ms": {k: round(v, 4)
                                        for k, v in split_ms.items()},
                           "split": split, "same_bits_as_parent": same,
                           "this_twice_same_bits": again})
    return result


def slstm_bwd(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    m = importlib.import_module("repro_torch.kernels.slstm_scan")
    # the parent's entry: r, pre, steps, dhs, carry, dpre, db, the dtypes,
    # B, T, nh, dh and the stream
    old = parent_entry(parent, "slstm_scan_bwd.cu", "slstm_scan_bwd",
                       (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
                       + (ctypes.c_void_p,))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    B, T, nh, dh = cs.SLSTM_BWD_TRAIN
    result = []
    for r_dtype in (torch.bfloat16, torch.float32):
        wx, r, b = cs.slstm_inputs(gen, B, T, nh, dh, torch.float32, True,
                                   r_dtype)
        dhs = cs.randn(gen, B, T, nh, dh)
        _, (pre, steps) = m._forward(wx, r, b, trace=True)

        def parent_call():            # as the parent's wrapper
            carry = torch.zeros(3, B, nh, dh, device="cuda")
            dpre = torch.empty(B, T, nh, 4 * dh, device="cuda")
            db = torch.empty(nh, 4 * dh, device="cuda")
            code = old(r.data_ptr(), pre.data_ptr(), steps.data_ptr(),
                       dhs.data_ptr(), carry.data_ptr(), dpre.data_ptr(),
                       db.data_ptr(), m._DTYPES[wx.dtype], m._DTYPES[r_dtype],
                       B, T, nh, dh, torch.cuda.current_stream().cuda_stream)
            cs.build.check(code, "parent slstm_scan_bwd")
            h_prev = torch.cat([torch.zeros_like(steps[3, :, :1]),
                                steps[3, :, :-1]], dim=1)
            dr = torch.einsum("btnd,btne->nde", h_prev, dpre)
            return dpre, dr.to(r_dtype), db

        this_call = lambda: m.slstm_scan_bwd(wx, r, b, dhs,
                                             trace=(pre, steps))
        names = ("dwx", "dr", "db")
        got = {"parent": parent_call(), "this": this_call()}
        again = all(torch.equal(x, y) for x, y in zip(this_call(),
                                                      got["this"]))
        want = m.slstm_scan_bwd_ref(wx, r, b, dhs)
        diff = {n: float((x.float() - y.float()).abs().max())
                for n, x, y in zip(names, got["parent"], got["this"])}
        vs_plain = {side: {n: float((g.float() - w.float()).abs().max()
                                    / w.float().abs().max())
                           for n, g, w in zip(names, grads, want)}
                    for side, grads in got.items()}
        shape = f"B={B} T={T} nh={nh} dh={dh} wx fp32 r {str(r_dtype)[6:]}"
        for name, fn in (("parent", parent_call), ("this", this_call),
                         ("this", this_call), ("parent", parent_call)):
            result.append({"slstm_scan_bwd": name, "shape": shape,
                           "ms": cs.device_ms(fn, 3),
                           "max_abs_diff": diff,
                           "vs_plain_rel": vs_plain[name],
                           "this_twice_same_bits": again})
    return result


RMS_SHAPES = ((2048, 1024), (32768, 128), (16384, 128))   # rows, d


def rmsnorm(parent: Path) -> list:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    # an older entry served both dtypes and took a dtype code after
    # `partial`; this checkout's takes fp32 only
    dtyped = "void* partial, int dtype" in (parent / CSRC
                                            / "rmsnorm_bwd.cu").read_text()
    argtypes = (rms._BWD_ARGTYPES[:6] + (ctypes.c_int,) * dtyped
                + rms._BWD_ARGTYPES[6:])
    old = parent_entry(parent, "rmsnorm_bwd.cu", "rmsnorm_bwd", argtypes)
    gen = torch.Generator("cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = []
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in RMS_SHAPES:
            x, dy = (cs.randn(gen, rows, d, dtype=dtype) for _ in range(2))
            g = (1 + 0.1 * cs.randn(gen, d)).to(dtype)

            def parent_call():
                dx, dg = torch.empty_like(x), torch.empty_like(g)
                vec, group, _ = rms.plan(x.data_ptr() | g.data_ptr()
                                         | dy.data_ptr() | dx.data_ptr(), d,
                                         x.element_size())
                blocks = rms.bwd_blocks(rows, group, sms)
                part = torch.empty(blocks, d, device="cuda")
                code = old(x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                           dx.data_ptr(), dg.data_ptr(), part.data_ptr(),
                           *(rms._DTYPES[dtype],) * dtyped, rows, d, 1e-6,
                           vec, group, blocks,
                           torch.cuda.current_stream().cuda_stream)
                cs.build.check(code, "parent rmsnorm_bwd")
                return dx, dg

            this_call = lambda: rms.rmsnorm_bwd(x, g, dy, eps=1e-6)
            pairs = list(zip(parent_call(), this_call()))
            same = all(torch.equal(a, b) for a, b in pairs)
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in pairs)
            shape = f"rows={rows} d={d} {str(dtype)[6:]}"
            for name, fn in (("parent", parent_call), ("this", this_call),
                             ("this", this_call), ("parent", parent_call)):
                result.append({"rmsnorm_bwd": name, "shape": shape,
                               "ms": cs.device_ms(fn, 50),
                               "same_bits_as_parent": same,
                               "max_abs_diff": diff})
            xl, gl = (t.clone().requires_grad_(True) for t in (x, g))
            result.append({"rmsnorm_bwd": "F.rms_norm backward",
                           "shape": shape, "ms": cs.grad_device_ms(
                               lambda x_, g_: F.rms_norm(x_, (d,), g_, 1e-6),
                               (xl, gl), dy, 50)})
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--only",
                    default="flash,ssd,ssd_bwd,slstm_bwd,rmsnorm,serve",
                    help="comma-separated: flash, ssd, ssd_bwd, slstm_bwd, "
                    "rmsnorm, serve")
    ap.add_argument("--arch", default="qwen3-0.6b", help="the served model")
    ap.add_argument("--serve-one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve_one:
        print(json.dumps(serve(args.serve_one.resolve(), args.arch)),
              flush=True)
        return
    only = set(args.only.split(","))
    parent = args.parent.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = ((flash_fwd(parent) + flash_bwd(parent) + flash_bwd(parent, "bf16")
             + flash_bwd(parent, "bf16", BWD80)
             + sum((flash_sm90_fwd(parent, shape) for shape in FWD_SM90), [])
             if "flash" in only else [])
            + (ssd(parent) if "ssd" in only else [])
            + (ssd_bwd(parent) if "ssd_bwd" in only else [])
            + (slstm_bwd(parent) if "slstm_bwd" in only else [])
            + (rmsnorm(parent) if "rmsnorm" in only else []))
    for row in rows:
        print(json.dumps(row), flush=True)
    if "serve" in only:
        for tree in (parent, ROOT, ROOT, parent):
            subprocess.run([sys.executable, __file__, "--parent", str(parent),
                            "--arch", args.arch, "--serve-one", str(tree)],
                           check=True)


if __name__ == "__main__":
    main()

"""The rounding of the tensor-core bf16 flash backward
(``csrc/flash_attention_bwd_sm90.cu``) on the CPU: its plain version,
``flash_attention_bwd_ref(..., bf16_operands=True)``, which rounds P and dS
to bf16 where the kernels hand them to the tensor cores, against the fp32
formulas and against ``jax.vjp`` of the JAX package's attention; and the
kernels' source against what ``chip_smoke.py`` reads of it. The kernels
themselves run only on the card, where ``chip_smoke.py`` phase 4 holds them
against the same plain versions.

Tolerances: per row (the last dim), the error relative to the row's RMS
within the flash backward's own limit, ``chip_smoke.flash_bwd_rows_ok`` (the
check the kernels pass on the card): twice the bf16 rounding of the fp32
result plus a bound, from the same call's fp32 P and dS, on what rounding
each of them to bf16 once can move the row (its docstring derives it);
against JAX, each output's largest distance from JAX's fp32 result within
twice JAX's own bf16 distance from it (as ``test_torch_bf16_grads.py`` holds
the fp32 formulas). ``chip_smoke.bf16_rows_ok``, twice the output's rounding
alone, stays the limit of the rmsnorm backward.
"""
from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.attention import attend_naive as jax_attend_naive
from repro_torch.kernels import (build, flash_attention_bwd_ref,
                                 flash_attention_ref, rmsnorm_bwd_ref)

CASES = [   # B, T, S, H, KV, hd, window, q_offset, causal (chip_smoke's,
            # smaller)
    (2, 64, 64, 4, 2, 128, 0, 0, True),       # the full width's head dim, GQA
    (1, 137, 137, 4, 2, 128, 64, 0, True),    # ragged T with a window
    (4, 64, 64, 4, 2, 32, 0, 0, True),        # launch/train's reduced config
    (2, 100, 100, 8, 2, 64, 0, 0, True),      # hd 64, GQA group 4
    (1, 50, 150, 4, 2, 128, 0, 100, True),    # q_offset > 0
    (1, 75, 100, 8, 4, 64, 32, 0, False),     # non-causal, a window, S > T
    (2, 64, 64, 4, 4, 80, 0, 0, True),        # zamba2's hd 80, H = KV
    (1, 137, 137, 4, 2, 80, 64, 0, True),     # hd 80, GQA 2, a window
]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16_inputs(case, seed):
    """bf16 q, k, v, do from numpy, and the plain forward's bf16 o and fp32
    lse (as ``chip_smoke.flash_bwd_bf16_inputs`` draws them on the card)."""
    B, T, S, H, KV, hd, window, q_offset, causal = case
    rng = np.random.default_rng(seed)
    shapes = ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, T, H, hd))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(torch.bfloat16) for s in shapes)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


def _fp32_and_bounds(smoke, q, k, v, o, lse, do, kw):
    """The fp32 formulas on the bf16 inputs, and the operands' rounding
    bounds of ``chip_smoke.flash_bwd_rows_ok`` from the same call."""
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                   lse, do.float(), **kw)
    return want, smoke.flash_bwd_operand_bounds(q, k, v, o, lse, do, **kw)


@pytest.mark.parametrize("case", CASES)
def test_rounded_plain_backward_within_the_per_row_limit(case, capsys):
    """P and dS in bf16 keep dq, dk and dv within ``flash_bwd_rows_ok``'s
    limit of the fp32 formulas on the same bf16 inputs, on three draws
    (case7 at seed 70 among them, the draw that exceeded the output's
    rounding alone); the worst margin is printed. The rounding moves the
    result: the flag is not a no-op, and off it gives the fp32 formulas'
    bits."""
    smoke = _chip_smoke()
    worst = 0.0
    for seed in range(3):
        (q, k, v, o, lse, do), kw = _bf16_inputs(case, 70 + seed)
        want, bounds = _fp32_and_bounds(smoke, q, k, v, o, lse, do, kw)
        got = flash_attention_bwd_ref(q, k, v, o, lse, do, bf16_operands=True,
                                      **kw)
        ratio, _ = smoke.flash_bwd_rows_ok("flash_attention_bwd_ref rounded",
                                           f"{case} seed {seed}", got, want,
                                           bounds)
        worst = max(worst, ratio)
        plain = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        off = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                      bf16_operands=False, **kw)
        assert all(torch.equal(a, b) for a, b in zip(plain, off))
        assert not all(torch.equal(a, b) for a, b in zip(plain, got))
    with capsys.disabled():
        print(f"\n{case}: worst per-row error of the rounded plain backward "
              f"{worst:.3f}x its limit (margin {1 - worst:.3f})")
    assert worst <= 1.0, (case, worst)


def _without_first_keys(q, k, v, do, kw, n=64):
    """The rounded plain backward run without keys 0 .. n-1 (k and v from
    key n on, at q_offset - n, as ``chip_smoke``'s dropped-tile check runs
    the kernels), dk and dv zero for the dropped keys; all zeros where no
    key is left."""
    if k.shape[1] <= n:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    k2, v2 = k[:, n:].contiguous(), v[:, n:].contiguous()
    kw2 = dict(kw, q_offset=kw["q_offset"] - n)
    o2, lse2 = flash_attention_ref(q, k2, v2, with_lse=True, **kw2)
    dq, dk, dv = flash_attention_bwd_ref(q, k2, v2, o2, lse2, do,
                                         bf16_operands=True, **kw2)
    pad = lambda t: F.pad(t, (0, 0, 0, 0, n, 0))
    return dq, pad(dk), pad(dv)


@pytest.mark.parametrize("case", CASES)
def test_dropped_keys_fail_the_per_row_limit(case):
    """A run without the first 64 keys fails ``flash_bwd_rows_ok`` against
    the whole run's fp32 formulas and bounds: the operands' term does not
    widen the limit past a missing key tile."""
    smoke = _chip_smoke()
    (q, k, v, o, lse, do), kw = _bf16_inputs(case, 70)
    want, bounds = _fp32_and_bounds(smoke, q, k, v, o, lse, do, kw)
    ratio, _ = smoke.flash_bwd_rows_ok(
        "flash_attention_bwd_ref rounded", f"{case} without keys 0..63",
        _without_first_keys(q, k, v, do, kw), want, bounds)
    assert ratio > 1.0, (case, ratio)


@pytest.mark.parametrize("case,fault", [(c, None) for c in CASES] + [
    (CASES[i], fault) for fault in ("forward", "backward") for i in (0, 5, 7)])
def test_residual_check_holds_o_lo_and_sees_it_dropped(case, fault,
                                                        monkeypatch):
    """``chip_smoke.check_flash_residual`` through the plain versions (the
    backward rounding P and dS as the kernels do): o + o_lo passes within
    2^-16 of the exact output, and the backward fed it within its widened
    limit, while the check's own zeroed o_lo fails it; a forward that
    writes no residual, or a backward that ignores it, fails the check."""
    smoke = _chip_smoke()
    B, T, S, H, KV, hd, window, q_offset, causal = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    forward, backward = smoke.flash_forward, flash_attention_bwd_ref

    def kernel_forward(*args, **kwargs):
        o, lse, o_lo = forward(*args, **kwargs)
        return o, lse, torch.zeros_like(o_lo) if fault == "forward" else o_lo

    def kernel_backward(q, k, v, o, lse, do, o_lo=None, **mask):
        o_lo = torch.zeros_like(o_lo) if fault == "backward" else o_lo
        return backward(q, k, v, o, lse, do, o_lo=o_lo, bf16_operands=True,
                        **mask)

    monkeypatch.setattr(smoke, "flash_forward", kernel_forward)
    monkeypatch.setattr(smoke, "flash_attention_bwd", kernel_backward)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    check = lambda: smoke.check_flash_residual(
        torch.Generator().manual_seed(7), B, T, S, H, KV, hd, kw, str(case))
    if fault is None:
        check()
    else:
        with pytest.raises(RuntimeError, match="o_lo|o \\+ o_lo"):
            check()


def test_bf16_rows_ok_keeps_its_limit_for_the_rmsnorm_backward():
    """``bf16_rows_ok`` still holds a row to twice the bf16 rounding of the
    fp32 result alone, and the rmsnorm backward's checks still call it (the
    flash backward's call sites take ``flash_bwd_rows_ok``)."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(5)
    x, dy = (torch.from_numpy(rng.standard_normal((64, 256))
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(256)
                         .astype(np.float32)).to(torch.bfloat16)
    want = rmsnorm_bwd_ref(x.float(), g.float(), dy.float(), eps=1e-6)
    got = tuple(w.to(torch.bfloat16) for w in want)
    ratio, err = smoke.bf16_rows_ok("rmsnorm_bwd_bf16", "rounded", got, want)
    assert err == 0.0 and ratio == 0.5       # each error is half its limit
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    calls = lambda fn, kernel: len(re.findall(rf"\b{fn}\(\s*\"{kernel}\"",
                                              text))
    assert calls("bf16_rows_ok", "rmsnorm_bwd_bf16") == 2
    assert calls("bf16_rows_ok", "flash_attention_bwd_bf16") == 0
    assert calls("flash_bwd_rows_ok", "flash_attention_bwd_bf16") == 5


@pytest.mark.parametrize("case", CASES)
def test_rounded_plain_backward_vs_jax_vjp(case):
    """dq, dk, dv with P and dS in bf16 (fed the fp32 forward's o and lse,
    as ``test_torch_bf16_grads.py`` feeds the fp32 formulas) against
    jax.vjp of ``attend_naive`` in bf16 and fp32 on the same bf16-rounded
    inputs: within twice JAX's own bf16 error."""
    (q, k, v, _, _, do), kw = _bf16_inputs(case, 80)
    o, lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                 with_lse=True, **kw)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, bf16_operands=True,
                                  **kw)
    arrays = [t.float().numpy() for t in (q, k, v, do)]
    want = []
    for dtype in (jnp.bfloat16, jnp.float32):
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_attend_naive(q_, k_, v_, **kw),
                         *(jnp.asarray(a, dtype) for a in arrays[:3]))
        want.append(vjp(jnp.asarray(arrays[3], dtype)))
    for name, g, w16, w32 in zip("dq dk dv".split(), got, *want):
        exact = np.asarray(w32, np.float64)
        jax_err = np.abs(np.asarray(w16.astype(jnp.float32), np.float64)
                         - exact).max()
        err = np.abs(g.double().numpy() - exact).max()
        assert 0 < jax_err and err <= 2 * jax_err, (name, err, jax_err)


def _code(name):
    return "\n".join(line.split("//")[0] for line in
                     (build.CSRC / name).read_text().splitlines())


def test_kernel_names_are_the_ones_chip_smoke_traces():
    """``chip_smoke.py`` splits the bf16 backward's time by kernel name and
    counts the Trainer's dq launches in its trace: each name it looks for is
    a kernel that the source launches."""
    smoke = _chip_smoke()
    code = _code("flash_attention_bwd_sm90.cu")
    for name in smoke.BF16_BWD_KERNELS.values():
        assert re.search(rf"{name}<HD><<<", code), name
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert '"flash_bwd_dq_sm90_kernel<": want["flash_attention_bwd"]' in text


def test_sm90_backward_switches_take_the_backward_head_dims():
    """The C entries have a case for each hd the wrapper lets through to a
    bf16 backward (32, 64, 80, 128), in both switches, and no other."""
    flash_module = importlib.import_module(
        "repro_torch.kernels.flash_attention")
    code = _code("flash_attention_bwd_sm90.cu")
    cases = [int(n) for n in re.findall(r"case (\d+):", code)]
    dims = flash_module._BWD_HEAD_DIMS[torch.bfloat16]
    assert sorted(set(cases)) == sorted(dims) == [32, 64, 80, 128]
    assert len(cases) == 2 * len(dims)

"""The port's kernel wrappers on the CPU, against the JAX package's kernels.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions against the Pallas kernels in interpret mode
(and against ``attend_naive`` at ragged lengths the Pallas wrapper cannot
tile), on the same numpy inputs. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 2e-5 (same math, different summation order); bf16 2e-2
(both sides compute in fp32 from identical bf16 inputs, the outputs may
round one bf16 ulp apart). The scans' plain versions step one token at a
time, as ``repro/kernels/ref.py`` does; the Pallas kernels and
``ssd_chunked`` work chunk by chunk.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.slstm_scan import slstm_scan as jax_slstm
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.models.attention import attend_naive as jax_attend_naive
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import (LAUNCHES, build, flash_attention,
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_ref, slstm_scan, slstm_scan_ref,
                                 ssd_scan, ssd_scan_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shapes, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in shapes]
    jax_side = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    torch_side = [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays]
    return jax_side, torch_side


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,H,KV,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 128, 128, 4, 2, 64),      # GQA 2:1
    (1, 128, 384, 4, 4, 64),      # cross lengths (q_offset)
])
def test_flash_plain_vs_pallas(B, T, S, H, KV, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, (B, T, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd), dtype=dtype)
    off = S - T
    want = jax_flash(jq, jk, jv, causal=True, q_offset=off, block_q=128,
                     block_k=128, interpret=True)
    got = flash_attention_ref(tq, tk, tv, causal=True, q_offset=off)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 64), (True, 128),
                                           (False, 0)])
def test_flash_plain_window_and_noncausal_vs_pallas(causal, window):
    B, T, H, hd = 1, 256, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, *[(B, T, H, hd)] * 3)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=128,
                     block_k=128, interpret=True)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("T,S,q_offset", [(200, 200, 0), (1, 77, 76),
                                          (37, 100, 63)])
def test_flash_plain_ragged_vs_attend_naive(T, S, q_offset):
    """Any T and S (the serving path prefills at the exact prompt length)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, (1, T, 4, 32), (1, S, 2, 32),
                                         (1, S, 2, 32))
    want = jax_attend_naive(jq, jk, jv, causal=True, window=0,
                            q_offset=q_offset)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=q_offset)
    _close(got, want, TOL["float32"])


def test_flash_plain_row_without_keys_gives_zero():
    """The TPU kernel's l == 0 finalise: a row that sees no key gives 0."""
    _, (q, k, v) = _inputs(3, (1, 4, 2, 32), (1, 4, 2, 32), (1, 4, 2, 32))
    out = flash_attention_ref(q, k, v, causal=True, q_offset=-2)
    assert torch.all(out[:, :2] == 0)
    assert torch.all(out[:, 2:].abs().sum(-1) > 0)


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 16, 256), (3, 1024)])
def test_rmsnorm_plain_vs_pallas(shape, dtype):
    (jx, jg), (tx, tg) = _inputs(4, shape, shape[-1:], dtype=dtype)
    want = jax_rmsnorm(jx, jg, interpret=True)
    got = rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])


# --------------------------------------------------------------------------
# SSD scan
# --------------------------------------------------------------------------
def _log_decay(seed, *shape):
    a = -np.abs(np.random.default_rng(seed).standard_normal(shape) * 0.3)
    return a.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,T,H,N,P,chunk", [
    (1, 128, 4, 16, 32, 32),      # tests/test_kernels.py:125-126, groups
    (2, 256, 2, 8, 64, 64),       # already expanded to heads
])
def test_ssd_plain_vs_pallas(b, T, H, N, P, chunk, dtype):
    (jx, jB, jC), (tx, tB, tC) = _inputs(6, (b, T, H, P), (b, T, H, N),
                                         (b, T, H, N), dtype=dtype, scale=0.5)
    a = _log_decay(7, b, T, H)
    want = jax_ssd(jx, jnp.asarray(a), jB, jC, chunk=chunk, interpret=True)
    got, state = ssd_scan_ref(tx, torch.from_numpy(a), tB, tC)
    assert got.dtype == tx.dtype and state.shape == (b, H, N, P)
    _close(got, want, TOL[dtype])
    _close(got, jax_ref.ssd_ref(jx, jnp.asarray(a), jB, jC), TOL[dtype])


@pytest.mark.parametrize("T,chunk", [(37, 37), (512, 128)])
def test_ssd_plain_state_and_normalizer_vs_ssd_chunked(T, chunk):
    """A ragged T (one chunk) and a multi-chunk T, from an initial state,
    with the normalizer chain: y, n and both final states."""
    b, H, N, P = 1, 2, 16, 32
    (jx, jB, jC, jS, jw, jSn), (tx, tB, tC, tS, tw, tSn) = _inputs(
        8, (b, T, H, P), (b, T, H, N), (b, T, H, N), (b, H, N, P), (b, T, H),
        (b, H, N), scale=0.5)
    a = _log_decay(9, b, T, H)
    want = jax_ssd_chunked(jx, jnp.asarray(a), jB, jC, chunk, initial_state=jS,
                           norm_weights=jw, initial_norm_state=jSn)
    got = ssd_scan(tx, torch.from_numpy(a), tB, tC, initial_state=tS,
                   norm_weights=tw, initial_norm_state=tSn)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


# --------------------------------------------------------------------------
# sLSTM scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,nh,dh,chunk", [
    (2, 64, 2, 16, 16),           # tests/test_kernels.py:198-199
    (1, 128, 4, 32, 64),
])
def test_slstm_plain_vs_pallas(B, T, nh, dh, chunk, dtype):
    (jwx,), (twx,) = _inputs(10, (B, T, nh, 4 * dh), dtype=dtype, scale=0.5)
    (jr, jb), (tr, tb) = _inputs(11, (nh, dh, 4 * dh), (nh, 4 * dh),
                                 scale=0.3)
    want = jax_slstm(jwx, jr, jb, chunk=chunk, interpret=True)
    got, (c, n, m, h) = slstm_scan_ref(twx, tr, tb)
    assert got.dtype == twx.dtype
    _close(got, want, TOL[dtype])
    _close(got, jax_ref.slstm_ref(jwx, jr, jb), TOL[dtype])
    assert all(s.shape == (B, nh, dh) and s.dtype == torch.float32
               for s in (c, n, m, h))
    if dtype == "float32":
        assert torch.equal(h, got[:, -1])


# --------------------------------------------------------------------------
# wrappers: plain only for CPU tensors, a kernel or an error otherwise
# --------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _, (q, k, v, x) = _inputs(5, (1, 9, 4, 32), (1, 9, 2, 32),
                              (1, 9, 2, 32), (3, 128))
    g = torch.ones(128)
    LAUNCHES.clear()
    assert torch.equal(ops.attention(q, k, v, q_offset=0),
                       flash_attention_ref(q, k, v))
    assert torch.equal(ops.norm(x, g, eps=1e-6), rmsnorm_ref(x, g))
    assert sum(LAUNCHES.values()) == 0


def test_other_devices_raise():
    q = torch.empty(1, 8, 4, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm(q, torch.empty(32, device="meta"))


def test_build_compiles_every_source_for_sm90a(monkeypatch):
    """One nvcc per source (run in parallel), then one link of the objects."""
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    out = build.library_path()
    for src in build.sources():
        cmd = build.compile_command(src, out.with_suffix(".o"))
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert str(src) in cmd
    link = build.link_command(["a.o", "b.o"], out)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert {"a.o", "b.o", str(out)} <= set(link)
    names = {p.name for p in build.sources()}
    assert {"flash_attention.cu", "rmsnorm.cu"} <= names
    assert out.parent == build.BUILD_DIR and out.parent.parts[-2:] == (
        "build", "kernels")


def test_scan_wrappers_on_cpu_tensors_launch_nothing():
    _, (x, B, C, wx, r, b) = _inputs(12, (1, 9, 2, 16), (1, 9, 2, 8),
                                     (1, 9, 2, 8), (1, 5, 2, 64), (2, 16, 64),
                                     (2, 64))
    a = torch.from_numpy(_log_decay(13, 1, 9, 2))
    w = torch.rand(1, 9, 2)
    LAUNCHES.clear()
    for got, want in zip(ops.ssd(x, a, B, C, norm_weights=w),
                         ssd_scan_ref(x, a, B, C, norm_weights=w)):
        assert torch.equal(got, want)
    hs, state = ops.slstm(wx, r, b)
    want_hs, want_state = slstm_scan_ref(wx, r, b)
    assert torch.equal(hs, want_hs)
    assert all(torch.equal(s, t) for s, t in zip(state, want_state))
    assert sum(LAUNCHES.values()) == 0


def test_scan_wrappers_raise_on_other_devices():
    x = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(x, x[..., 0], x, x)
    with pytest.raises(ValueError, match="no kernel"):
        slstm_scan(torch.empty(1, 8, 2, 64, device="meta"),
                   torch.empty(2, 16, 64, device="meta"),
                   torch.empty(2, 64, device="meta"))


def test_build_compiles_the_scan_kernels():
    names = {p.name for p in build.sources()}
    assert {"ssd_scan.cu", "slstm_scan.cu"} <= names

"""The port's kernel wrappers on the CPU, against the JAX package's kernels.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions against the Pallas kernels in interpret mode
(and against ``attend_naive`` at ragged lengths the Pallas wrapper cannot
tile), on the same numpy inputs. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 2e-5 (same math, different summation order); bf16 2e-2
(both sides compute in fp32 from identical bf16 inputs, the outputs may
round one bf16 ulp apart).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models.attention import attend_naive as jax_attend_naive
from repro_torch.kernels import (LAUNCHES, build, flash_attention,
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
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
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    out = build.library_path()
    cmd = build.nvcc_command(out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    names = {p.name for p in build.sources()}
    assert {"flash_attention.cu", "rmsnorm.cu"} <= names
    assert all(str(p) in cmd for p in build.sources())
    assert out.parent == build.BUILD_DIR and out.parent.parts[-2:] == (
        "build", "kernels")

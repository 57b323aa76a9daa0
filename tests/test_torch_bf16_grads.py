"""The bf16 gradients of the port's kernels on the CPU: the plain backward
formulas (``flash_attention_bwd_ref``, ``rmsnorm_bwd_ref``) and the
autograd Functions that run them on CPU tensors, against ``jax.vjp`` of the
JAX package's attention and norm in bf16, and the plain forward's lse for
bf16 inputs; then the C interface of the bf16 backward kernels, which run
only on the card (``chip_smoke.py`` phase 4 holds them against these plain
versions there).

Tolerance (bf16): per output, the port's largest distance from JAX's fp32
result of the same inputs must stay within twice JAX's own bf16 distance
from it (``jax.vjp`` in bf16 against ``jax.vjp`` in fp32): the port may be
at most twice as far from the exact result as the JAX package is. The lse
is fp32 arithmetic on bf16 inputs: 1e-5, as the fp32 lse is held.

One difference by design widens the attention's tolerance on the model's
path: a flash backward takes D = rowsum(do * o) from the forward's output,
which is bf16, where JAX's autodiff of its jnp attention sums P * dP in
fp32. The plain backward's formulas are therefore held fed the fp32
forward's o; through the autograd Function, which feeds it the bf16 o, what
rounding o to bf16 moves the plain backward by (on the same inputs) is
added to the tolerance.
"""
from __future__ import annotations

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend_naive as jax_attend_naive
from repro.models.attention import mask_bias as jax_mask_bias
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels import (LAUNCHES, build, flash_attention_bwd_ref,
                                 flash_attention_ref, ops, rmsnorm_bwd_ref)

flash_module = importlib.import_module("repro_torch.kernels.flash_attention")
rms_module = importlib.import_module("repro_torch.kernels.rmsnorm")

ATTN_CASES = [   # B, T, S, H, KV, hd, window, q_offset
    (2, 24, 24, 4, 2, 32, 0, 0),       # GQA, the reduced config's head dim
    (1, 40, 40, 4, 2, 32, 16, 0),      # GQA with a window
    (1, 33, 33, 4, 2, 128, 0, 0),      # the full width's head dim
    (1, 20, 20, 16, 8, 128, 8, 0),     # qwen3-0.6b's heads, a window
    (1, 12, 30, 4, 1, 128, 0, 18),     # q_offset, GQA group 4
]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16_torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _bf16_numpy(a):
    """``a`` rounded to bf16, as fp32 numpy (both sides start from it)."""
    return _bf16_torch(a).float().numpy()


def _within_twice_jax(got, want_bf16, want_fp32, what, extra=0.0):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    exact = np.asarray(want_fp32, np.float64)
    jax_err = np.abs(np.asarray(want_bf16.astype(jnp.float32), np.float64)
                     - exact).max()
    err = np.abs(got - exact).max()
    assert jax_err > 0, what
    assert err <= 2 * jax_err + extra, (what, err, jax_err, extra)


@functools.lru_cache(maxsize=None)
def _attention_case(case):
    """bf16-rounded inputs of a case and jax.vjp of ``attend_naive`` on them
    in bf16 and in fp32 (shared by the tests of one case)."""
    B, T, S, H, KV, hd, window, q_offset = case
    arrays = [_bf16_numpy(a) for a in _arrays(
        40, (B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, T, H, hd))]

    @jax.jit
    def vjps(q, k, v, do):
        out = []
        for dtype in (jnp.bfloat16, jnp.float32):
            _, vjp = jax.vjp(lambda q_, k_, v_: jax_attend_naive(
                q_, k_, v_, causal=True, window=window, q_offset=q_offset),
                *(t.astype(dtype) for t in (q, k, v)))
            out.append(vjp(do.astype(dtype)))
        return out

    want16, want32 = vjps(*arrays)
    return arrays, want16, want32


@pytest.mark.parametrize("B,T,S,H,KV,hd,window,q_offset", ATTN_CASES)
def test_flash_bwd_ref_bf16_vs_jax_vjp(B, T, S, H, KV, hd, window, q_offset):
    """dq, dk, dv of the plain backward on bf16 q, k, v and do (with the
    fp32 forward's o and lse: module doc), against jax.vjp of
    ``attend_naive`` in bf16 and in fp32."""
    arrays, want16, want32 = _attention_case((B, T, S, H, KV, hd, window,
                                              q_offset))
    q, k, v, do = (_bf16_torch(a) for a in arrays)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                 with_lse=True, **kw)
    assert lse.dtype == torch.float32
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w16, w32, t in zip("dq dk dv".split(), got, want16, want32,
                                    (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        _within_twice_jax(g, w16, w32, name)


@pytest.mark.parametrize("B,T,S,H,KV,hd,window,q_offset", ATTN_CASES[:4])
def test_flash_function_bf16_cpu_vs_jax_vjp(B, T, S, H, KV, hd, window,
                                            q_offset):
    """The same through ``ops.attention`` and autograd (the model's path on
    CPU tensors, the forward's bf16 o and its rounding residual fed to the
    backward): it launches nothing, and its output gradients are the plain
    backward's."""
    arrays, want16, want32 = _attention_case((B, T, S, H, KV, hd, window,
                                              q_offset))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    leaves = [_bf16_torch(a).requires_grad_(True) for a in arrays[:3]]
    do = _bf16_torch(arrays[3])
    before = sum(LAUNCHES.values())
    out = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    assert sum(LAUNCHES.values()) == before
    q, k, v = (t.detach() for t in leaves)
    o32, lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                   with_lse=True, **kw)
    o_lo = flash_attention_ref(q, k, v, with_lse=True, with_residual=True,
                               **kw)[2]
    with_o16 = flash_attention_bwd_ref(q, k, v, out.detach(), lse, do,
                                       o_lo=o_lo, **kw)
    with_o32 = flash_attention_bwd_ref(q, k, v, o32, lse, do, **kw)
    for name, g, w16, w32, a, b in zip("dq dk dv".split(), got, want16,
                                       want32, with_o16, with_o32):
        assert torch.equal(g, a), name
        moved = float((a.double() - b.double()).abs().max())
        _within_twice_jax(g, w16, w32, name, extra=moved)


@pytest.mark.parametrize("B,T,S,H,KV,hd,window,q_offset", ATTN_CASES)
def test_flash_plain_lse_bf16_vs_jax(B, T, S, H, KV, hd, window, q_offset):
    """The plain forward's lse on bf16 inputs: log-sum-exp of the scaled,
    masked scores in fp32, as JAX computes them from the same inputs."""
    qa, ka = (_bf16_numpy(a) for a in _arrays(42, (B, T, H, hd),
                                              (B, S, KV, hd)))
    q, k = jnp.asarray(qa, jnp.bfloat16), jnp.asarray(ka, jnp.bfloat16)
    k_rep = jnp.repeat(k, H // KV, axis=2)
    scores = jnp.einsum("bthd,bshd->bhts", q, k_rep,
                        preferred_element_type=jnp.float32) / math.sqrt(hd)
    scores = scores + jax_mask_bias(jnp.arange(T) + q_offset, jnp.arange(S),
                                    True, window)[None, None]
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    tq, tk = _bf16_torch(qa), _bf16_torch(ka)
    _, lse = flash_attention_ref(tq, tk, tk, window=window, q_offset=q_offset,
                                 with_lse=True)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@jax.jit
def _rms_vjps(x, g, dy):
    """jax.vjp of ``rms_norm`` in bf16 and in fp32."""
    out = []
    for dtype in (jnp.bfloat16, jnp.float32):
        _, f = jax.vjp(lambda x_, g_: jax_rms_norm(x_, g_, 1e-6),
                       x.astype(dtype), g.astype(dtype))
        out.append(f(dy.astype(dtype)))
    return out


@pytest.mark.parametrize("shape", [(2, 16, 128), (2, 16, 4, 32),
                                   (2, 8, 16, 128), (4, 1024), (5, 100)])
def test_rmsnorm_bwd_ref_bf16_vs_jax_vjp(shape):
    """dx and dg of the plain backward on bf16 x, gain and dy against
    jax.vjp of ``rms_norm`` (cast to fp32, compute, cast back) in bf16 and
    fp32: d_model 128, q/k_norm at hd 32 and 128, 1024, a tail."""
    d = shape[-1]
    x, dy = (_bf16_numpy(a) for a in _arrays(43, shape, shape))
    g = _bf16_numpy(1 + 0.1 * _arrays(44, (d,))[0])

    want16, want32 = _rms_vjps(x, g, dy)

    got = rmsnorm_bwd_ref(_bf16_torch(x), _bf16_torch(g), _bf16_torch(dy),
                          eps=1e-6)
    for name, t, w16, w32 in zip(("dx", "dg"), got, want16, want32):
        assert t.dtype == torch.bfloat16
        _within_twice_jax(t, w16, w32, name)


@pytest.mark.parametrize("shape", [(2, 16, 128), (3, 1024)])
def test_rmsnorm_function_bf16_cpu_vs_jax_vjp(shape):
    d = shape[-1]
    x, dy = (_bf16_numpy(a) for a in _arrays(45, shape, shape))
    g = _bf16_numpy(1 + 0.1 * _arrays(46, (d,))[0])

    want16, want32 = _rms_vjps(x, g, dy)

    leaves = [_bf16_torch(x).requires_grad_(True),
              _bf16_torch(g).requires_grad_(True)]
    got = torch.autograd.grad(ops.norm(*leaves, eps=1e-6), leaves,
                              _bf16_torch(dy))
    for name, t, w16, w32 in zip(("dx", "dg"), got, want16, want32):
        _within_twice_jax(t, w16, w32, name)


# --------------------------------------------------------------------------
# the C interface of the bf16 backward kernels (built and run on the card)
# --------------------------------------------------------------------------
def _c_params(name):
    """Arguments of the C entry ``name`` in the sources."""
    for src in build.sources():
        text = src.read_text()
        head = f'extern "C" int {name}('
        if head in text:
            sig = text[text.index(head):]
            return sig[:sig.index(")")].count(",") + 1
    raise AssertionError(f"no C entry {name}")


def test_bf16_backward_entries_take_what_the_wrappers_pass():
    """Each dtype has its own flash backward entry, the bf16 one taking the
    fp32 entry's arguments and the output's rounding residual; the sm90
    forward takes an lse pointer and the residual's (one more than the fp32
    forward); each dtype has its own rmsnorm backward entry too, the bf16
    one taking ``bwd_plan``'s layout where the fp32 one takes the forward's
    ``plan`` and ``bwd_blocks``."""
    assert flash_module._BWD_ENTRY == {
        torch.float32: "flash_attention_bwd",
        torch.bfloat16: "flash_attention_bwd_bf16"}
    assert _c_params("flash_attention_bwd") == len(
        flash_module._BWD_ARGTYPES) == 21
    assert _c_params("flash_attention_bwd_bf16") == len(
        flash_module._BWD_BF16_ARGTYPES) == 22
    for entry in flash_module._BWD_ENTRY.values():
        assert _c_params(f"{entry}_occupancy") == len(
            flash_module._OCC_ARGTYPES)
    for entry in flash_module._ENTRY.values():
        assert _c_params(entry) == len(flash_module._ARGTYPES[entry])
    assert [len(flash_module._ARGTYPES[e]) for e in (
        "flash_attention_fwd", "flash_attention_sm90_fwd")] == [16, 17]
    assert rms_module._BWD_ENTRY == {torch.float32: "rmsnorm_bwd",
                                     torch.bfloat16: "rmsnorm_bwd_bf16"}
    assert _c_params("rmsnorm_bwd") == len(rms_module._BWD_ARGTYPES)
    assert _c_params("rmsnorm_bwd_bf16") == len(rms_module._BWD_BF16_ARGTYPES)


def _code(name):
    return "\n".join(line.split("//")[0] for line in
                     (build.CSRC / name).read_text().splitlines())


def test_bf16_backward_kernels_read_bf16_themselves():
    """The bf16 flash backward is its own tensor-core source: its C entries
    live in ``flash_attention_bwd_sm90.cu``, whose three kernels read bf16
    tiles placed by TMA and run every tile product as a wgmma (none on the
    CUDA cores of ``flash_tiles.cuh``), with no atomics; the fp32 backward
    no longer instantiates anything in bf16. So with the rmsnorm backward:
    its bf16 entry lives in ``rmsnorm_bwd_sm90.cu``, whose kernels read bf16
    rows themselves (16 bytes a load on the 16-byte path; no cast of the
    inputs to fp32 around the fp32 kernels) and which launches its own
    kernels, with no atomics; ``rmsnorm_bwd.cu`` instantiates nothing in
    bf16."""
    flash = _code("flash_attention_bwd_sm90.cu")
    for entry in ("flash_attention_bwd_bf16",
                  "flash_attention_bwd_bf16_occupancy"):
        assert f'extern "C" int {entry}(' in flash, entry
    for kernel in ("flash_bwd_delta_kernel", "flash_bwd_dkdv_sm90_kernel",
                   "flash_bwd_dq_sm90_kernel"):
        assert f"{kernel}<HD><<<" in flash, kernel
    for used in ("wgmma_ss_n64(", "wgmma_rs(", "tma_load_4d(", "mbar_wait(",
                 "make_map(", '#include "sm90.cuh"',
                 "__nv_bfloat16* __restrict__ dk"):
        assert used in flash, used
    assert "wgmma.mma_async" in _code("sm90.cuh")
    for gone in ("flash_tiles.cuh", "rows_dot_rows", "cols_by_rows"):
        assert gone not in flash, gone
    fp32 = _code("flash_attention_bwd.cu")
    assert "__nv_bfloat16" not in fp32
    assert "flash_attention_bwd_bf16" not in fp32
    assert "const __nv_bfloat16* src" not in _code("flash_tiles.cuh")
    rms = _code("rmsnorm_bwd.cu")
    assert "rmsnorm_bwd_kernel<VEC><<<" in rms
    assert "rmsnorm_bwd_dg_kernel<<<" in rms
    assert "__nv_bfloat16" not in rms and "rmsnorm_bwd_bf16" not in rms
    sm90 = _code("rmsnorm_bwd_sm90.cu")
    assert 'extern "C" int rmsnorm_bwd_bf16(' in sm90
    for kernel in ("f(rmsnorm_bwd_sm90_rows_kernel<1>)",
                   "f(rmsnorm_bwd_sm90_rows_kernel<2>)",
                   "f(rmsnorm_bwd_sm90_rows_kernel<4>)",
                   "f(rmsnorm_bwd_sm90_scalar_kernel)",
                   "cudaLaunchKernelEx(&cfg, kernel,",
                   "rmsnorm_bwd_sm90_dg_kernel<<<"):
        assert kernel in sm90, kernel
    for used in ("const bf16* __restrict__ x", "bf16* __restrict__ dx",
                 "ld_stream(x", "store_peer(", '#include "sm90.cuh"'):
        assert used in sm90, used
    for name in ("flash_attention_bwd_sm90.cu", "flash_attention_bwd.cu",
                 "rmsnorm_bwd.cu", "rmsnorm_bwd_sm90.cu"):
        assert "atomic" not in _code(name)


def test_sm90_forward_writes_lse_in_the_backwards_units():
    """The tensor-core forward writes lse as ln(2) * m + log(l) (m in its
    base-2 units), +inf where l is 0, and only where a pointer is given."""
    code = _code("flash_attention_sm90.cu")
    assert "lse != nullptr" in code
    assert "l0 == 0.f ? CUDART_INF_F : m0 * LN2 + logf(l0)" in code
    assert "l1 == 0.f ? CUDART_INF_F : m1 * LN2 + logf(l1)" in code


def test_bf16_backward_no_longer_raises_before_launch():
    """The error messages of a bf16 backward are gone: a bf16 backward
    reaches the launch (here, on a meta tensor, the meta path that stands
    in for it: checked and allocated as on the card, nothing launched)."""
    assert not hasattr(flash_module, "BF16_BACKWARD")
    assert not hasattr(rms_module, "BF16_BACKWARD")
    q = torch.empty(1, 8, 4, 32, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 4, 8, device="meta")
    grads = flash_module.flash_attention_bwd(q, q, q, q, lse, q, o_lo=q)
    assert all((t.device.type, t.dtype, t.shape) == ("meta", q.dtype,
                                                     q.shape) for t in grads)
    dx, dg = rms_module.rmsnorm_bwd(q, torch.empty(32, device="meta",
                                                   dtype=torch.bfloat16), q)
    assert (dx.shape, dg.shape) == (q.shape, (32,))
    assert dx.dtype == dg.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_takes_the_rounding_residual_in_bf16_only(dtype):
    """The bf16 backward's D reads o + o_lo, so a bf16 call without the
    forward's o_lo raises, as an fp32 call with one does, on the CPU as on
    the card; the bf16 entry rejects a null o_lo and its delta kernel reads
    o_lo on every row; the forward gives o_lo in bf16 training only."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 8, 2, 32, generator=gen).to(dtype)
                   for _ in range(4))
    o, lse, o_lo = flash_attention_ref(q, k, v, with_lse=True,
                                       with_residual=True)
    right, wrong = (o_lo, None) if dtype == torch.bfloat16 else (None, o_lo)
    with pytest.raises(ValueError, match="o_lo"):
        flash_module.flash_attention_bwd(q, k, v, o, lse, do, o_lo=wrong)
    got = flash_module.flash_attention_bwd(q, k, v, o, lse, do, o_lo=right)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, o_lo=right)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    out, lse2, out_lo = flash_module._forward(q, k, v, True, 0, 0, True)
    assert torch.equal(out, o) and torch.equal(lse2, lse)
    assert (out_lo is None) == (dtype == torch.float32)
    assert flash_module._forward(q, k, v, True, 0, 0, False)[2] is None
    code = _code("flash_attention_bwd_sm90.cu")
    assert "o_lo == nullptr)" in code
    assert "o_lo != nullptr" not in code
    assert "__bfloat162float(o_lo[row * HD + c])" in code

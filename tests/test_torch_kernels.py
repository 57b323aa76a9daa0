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

import importlib
import importlib.util
import math
import re
from pathlib import Path

import jax
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
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels.rmsnorm import bwd_blocks as rmsnorm_bwd_blocks
from repro_torch.kernels.rmsnorm import plan as rmsnorm_plan
from repro_torch.kernels import (LAUNCHES, build, flash_attention,
                                 flash_attention_bwd, flash_attention_bwd_ref,
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref,
                                 slstm_scan, slstm_scan_ref, ssd_scan,
                                 ssd_scan_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the module (the package's ``flash_attention`` attribute is the function)
flash_module = importlib.import_module("repro_torch.kernels.flash_attention")
rms_module = importlib.import_module("repro_torch.kernels.rmsnorm")
ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")
slstm_module = importlib.import_module("repro_torch.kernels.slstm_scan")


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


def _live_tiles(r0, T, S, causal, window, q_offset, rows=64, block_k=64):
    """``live_tiles`` of ``csrc/flash_attention_sm90.cu``: the key tiles
    [begin, end) that some of the ``rows`` query rows from r0 see; empty
    when r0 is past T."""
    n_kt = -(-S // block_k)
    if r0 >= T:
        return 0, 0
    q_first, q_last = r0 + q_offset, min(r0 + rows, T) - 1 + q_offset
    end = (0 if q_last < 0 else min(n_kt, q_last // block_k + 1)) \
        if causal else n_kt
    begin = max(0, (q_first - window + 1) // block_k) if window > 0 else 0
    return begin, end


def _sm90_emulation(q, k, v, *, causal, q_offset=0, block_k=64, rows=64):
    """The bf16 tensor-core kernel's arithmetic (``csrc/flash_attention_sm90.cu``)
    written out in fp32: 64-key tiles, a running max in log2 units, exp2 with
    scale*log2(e) folded in, fp32 row sums of the unrounded P, and P rounded
    to bf16 before P V (the one departure from the TPU kernel). Each group
    of ``rows`` query rows (a block: 64 rows, at hd 192 too) runs only its
    live tiles."""
    B, T, H, hd = q.shape
    S, group = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    c = math.log2(math.e) / math.sqrt(hd)
    ok = flash_module.visible(T, S, q_offset, causal, 0, q.device)
    out = torch.zeros(B, H, T, hd)
    for r0 in range(0, T, rows):
        r1 = min(r0 + rows, T)
        m = torch.full((B, H, r1 - r0, 1), -math.inf)
        l = torch.zeros(B, H, r1 - r0, 1)
        acc = torch.zeros(B, H, r1 - r0, hd)
        begin, end = _live_tiles(r0, T, S, causal, 0, q_offset, rows, block_k)
        for k0 in range(begin * block_k, end * block_k, block_k):
            s = qf[:, :, r0:r1] @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
            s = torch.where(ok[r0:r1, k0:k0 + block_k], s, -math.inf)
            new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            ref = torch.where(new == -math.inf, 0.0, new)
            alpha = torch.exp2(m - ref)
            p = torch.exp2(s * c - ref)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = (acc * alpha
                   + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + block_k])
            m = new
        out[:, :, r0:r1] = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def test_sm90_emulation_pruned_tiles_change_no_bit():
    """Running only a row group's live tiles gives the bits of running
    every tile: a tile no row of the group sees leaves m, l and acc as
    they are (alpha is exactly 1, or 0 on a row with no key yet)."""
    _, (q, k, v) = _inputs(9, (1, 200, 4, 32), (1, 264, 2, 32),
                           (1, 264, 2, 32), dtype="bfloat16")
    for off in (64, -40):
        every = _sm90_emulation(q, k, v, causal=True, q_offset=off,
                                rows=10_000)
        for rows in (64, 128):
            got = _sm90_emulation(q, k, v, causal=True, q_offset=off,
                                  rows=rows)
            assert torch.equal(got, every), (off, rows)
    assert _live_tiles(128, 100, 100, True, 0, 0) == (0, 0)
    assert _live_tiles(0, 1, 1100, True, 0, 1099) == (0, 18)
    assert _live_tiles(64, 300, 300, True, 100, 0) == (0, 2)
    assert _live_tiles(192, 300, 300, True, 100, 0) == (1, 4)


@pytest.mark.parametrize("B,T,S,H,KV,hd", [
    (1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 1, 32),
    (1, 128, 384, 4, 4, 64), (2, 384, 384, 2, 2, 128),
    (1, 128, 128, 4, 2, 80),             # zamba2's shared-block head dim
    (1, 128, 128, 12, 1, 192),           # nemotron's hd 192 at GQA 12
    (1, 100, 100, 12, 1, 192),           # a 128-row block half empty
])                                       # the bf16 grid of tests/test_kernels.py
def test_flash_sm90_bf16_arithmetic_vs_pallas(B, T, S, H, KV, hd):
    """Rounding P to bf16 before P V stays inside the bf16 tolerance. hd 192
    has a kernel of its own with the same 64-row arithmetic (its blocks
    differ in their buffering and in how O is stored): the emulation runs
    64-row groups; at T=100 the second group is ragged."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(6, (B, T, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd), dtype="bfloat16")
    off = S - T
    want = jax_flash(jq, jk, jv, causal=True, q_offset=off, block_q=128,
                     block_k=128, interpret=True)
    got = _sm90_emulation(tq, tk, tv, causal=True, q_offset=off)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])



def _swizzled(offset, sw):
    """TMA's swizzle of a byte offset in a box with rows of ``sw`` bytes
    (CUTLASS's Swizzle<log2(sw / 16), 4, 3>): bits 4.. of the offset XOR
    bits 7.. of it, as many bits as a row has 16-byte chunks' index."""
    mask = sw // 16 - 1
    return offset ^ (((offset >> 7) & mask) << 4)


@pytest.mark.parametrize("sw", [32, 64, 128])
def test_fragment_stores_use_the_swizzle_tma_reads(sw):
    """The tiles that the hd 192 forward (``store_o``) and the bf16 backward
    (``tile_from_frag``) write from a fragment, for TMA to store, put every
    byte where TMA's swizzle puts it: row r's chunk c at
    r * sw + (c ^ ((r * sw >> 7) % (sw / 16))) * 16, as the sources write
    it, and no two bytes of a tile on one address."""
    seen = set()
    for r in range(64):
        for x in range(sw):
            c, within = divmod(x, 16)
            kernel = r * sw + (c ^ ((r * sw >> 7) & (sw // 16 - 1))) * 16 + within
            assert kernel == _swizzled(r * sw + x, sw), (r, x)
            seen.add(kernel)
    assert seen == set(range(64 * sw))
    fwd = _code("flash_attention_sm90.cu")
    bwd = _code("flash_attention_bwd_sm90.cu")
    assert "(((i % 8) ^ (r0 & 7)) * 16)" in fwd            # sw 128: r * 128 >> 7 = r
    assert "((c ^ ((r * T::SW >> 7) & (T::SW / 16 - 1))) * 16)" in bwd


def test_hd192_forward_is_a_kernel_of_its_own_three_blocks_an_sm():
    """``case 192`` launches the hd 192 kernel (64-row blocks, Q, K and V one
    24 KB tile each, O stored by TMA) whose shared memory lets three blocks
    share an SM's 228 KB (1 KB of it reserved per block); every other head
    dim launches the kernel it launched before."""
    code = _code("flash_attention_sm90.cu")
    assert "case 192: return launch_hd192<192>(" in code
    for hd in (32, 64, 80, 128):
        assert f"case {hd}: return launch<{hd}>(" in code
    assert "__launch_bounds__(NT, H192_BLOCKS)" in code
    blocks = int(re.search(r"constexpr int H192_BLOCKS = (\d+);", code).group(1))
    tile = 64 * 192 * 2
    smem = 3 * tile + 8 * 3 + 1024
    assert blocks == 3 and blocks * (smem + 1024) <= 233_472
    assert "tma_store_4d(&omap" in code and "load(Ks, &kmap, kbar" in code


def test_bf16_backward_hd80_tiles_have_no_padding():
    """At hd 80 the bf16 backward's tiles are five 16-column atoms in 32-byte
    swizzle (80 columns, 10,240 bytes), its dV, dK and dQ products
    m64n80k16, dk/dv run by one warpgroup a block holding both
    accumulators, and the tensor maps take a 32-byte swizzle."""
    code = _code("flash_attention_bwd_sm90.cu")
    assert "static constexpr int W = HD;" in code
    assert "HD == 80 ? 32 :" in code
    assert "m64n80k16" in _code("sm90.cuh")
    assert "CU_TENSOR_MAP_SWIZZLE_32B" in _code("sm90.cuh")
    assert "flash_bwd_dkdv_sm90_kernel_one_wg<HD><<<kv_grid, WG," in code
    blocks = int(re.search(r"constexpr int ONE_WG_BLOCKS = (\d+);", code).group(1))
    tile = 64 * 80 * 2
    one_wg = 2 * tile + 2 * 2 * tile + 2 * 2 * 64 * 4 + 8 * 3 + 1024
    assert tile == 10_240 and blocks * (one_wg + 1024) <= 233_472

def _cuda_core_emulation(q, k, v, *, causal, window=0, q_offset=0,
                         block_k=64):
    """The fp32 CUDA-core kernel's arithmetic (``csrc/flash_attention.cu``)
    written out in fp32: 64-key tiles, S as the sum of two partials, one
    over the first 16 floats of every 32 of d and one over the other 16
    (the block's two halves), times the scale, then masked; the running
    max from -1e30, P = exp(S - m), alpha = exp(m_old - m), fp32 row sums;
    lse = m + log(l), +inf where l == 0. Returns (out, lse [B,H,T])."""
    B, T, H, hd = q.shape
    S, group = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    first = (torch.arange(hd) % 32) < 16         # role 0's half of d
    ok = flash_module.visible(T, S, q_offset, causal, window, q.device)
    m = torch.full((B, H, T, 1), flash_module.NEG_INF)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, hd)
    for k0 in range(0, S, block_k):
        kt = kf[:, :, k0:k0 + block_k]
        s = (qf[..., first] @ kt[..., first].transpose(-1, -2)
             + qf[..., ~first] @ kt[..., ~first].transpose(-1, -2))
        s = torch.where(ok[:, k0:k0 + block_k], s * (1.0 / math.sqrt(hd)),
                        -math.inf)
        new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - new)
        alpha = torch.exp(m - new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p @ vf[:, :, k0:k0 + block_k]
        m = new
    out = acc / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, math.inf, m + torch.log(l))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def _lse_close(got, want, tol=1e-5):
    """Rows with a visible key within tol + tol * |want|; the +inf rows
    (no visible key) identical."""
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and bool((got[inf] > 0).all())
    err = (got[~inf] - want[~inf]).abs()
    assert bool((err <= tol + tol * want[~inf].abs()).all()), float(err.max())


@pytest.mark.parametrize("B,T,S,H,KV,hd", [
    (1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 1, 32),
    (1, 128, 384, 4, 4, 64), (2, 384, 384, 2, 2, 128),
    (1, 128, 128, 4, 2, 80),             # zamba2's shared-block head dim
])                                       # the grid of tests/test_kernels.py
def test_flash_fp32_kernel_arithmetic_vs_pallas(B, T, S, H, KV, hd):
    """The fp32 kernel's split sum of S and its online softmax stay inside
    fp32's tolerance of the Pallas kernel, and its lse within 1e-5 of the
    plain version's."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(8, (B, T, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd))
    off = S - T
    want = jax_flash(jq, jk, jv, causal=True, q_offset=off, block_q=128,
                     block_k=128, interpret=True)
    got, lse = _cuda_core_emulation(tq, tk, tv, causal=True, q_offset=off)
    _close(got, want, TOL["float32"])
    _, want_lse = flash_attention_ref(tq, tk, tv, q_offset=off, with_lse=True)
    _lse_close(lse, want_lse)


@pytest.mark.parametrize("T,S,causal,window,q_offset", [
    (256, 256, True, 64, 0), (128, 128, False, 0, 0), (1, 77, True, 0, 76),
    (37, 100, True, 0, 63), (137, 73, True, 0, -64),
])
def test_flash_fp32_kernel_arithmetic_masks_and_empty_rows(T, S, causal,
                                                           window, q_offset):
    """Window, non-causal and ragged cases against the plain version; at
    q_offset -64 the first 64 rows see no key: 0 out, +inf lse."""
    _, (q, k, v) = _inputs(9, (1, T, 4, 32), (1, S, 2, 32), (1, S, 2, 32))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got, lse = _cuda_core_emulation(q, k, v, **kw)
    want, want_lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
    _close(got, want, TOL["float32"])
    _lse_close(lse, want_lse)
    if q_offset < 0:
        assert torch.isinf(lse[..., :-q_offset]).all()
        assert torch.all(got[:, :-q_offset] == 0)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_flash_per_row_check_passes_the_arithmetic_and_sees_a_dropped_tile():
    """``chip_smoke.py``'s per-row check at the T=137 prefill shape: the
    tensor-core kernel's arithmetic passes it, and the same arithmetic with
    the first 64-key tile skipped fails it (the absolute 2e-2 passes both
    wherever outputs are small)."""
    smoke = _chip_smoke()
    _, (q, k, v) = _inputs(7, (1, 137, 16, 128), (1, 137, 8, 128),
                           (1, 137, 8, 128), dtype="bfloat16")
    smoke.check_flash_rows(q, k, v, _sm90_emulation(q, k, v, causal=True),
                           "T=137")
    skipped = _sm90_emulation(q, k[:, 64:], v[:, 64:], causal=True,
                              q_offset=-64)
    with pytest.raises(RuntimeError, match="rows off the fp32 result"):
        smoke.check_flash_rows(q, k, v, skipped, "T=137, first tile skipped")


def test_flash_dtype_alone_picks_the_kernel():
    """bf16 goes to the tensor-core kernel, fp32 to the CUDA-core one, and
    each C entry point is defined by its own source."""
    assert flash_module._ENTRY == {torch.float32: "flash_attention_fwd",
                                   torch.bfloat16: "flash_attention_sm90_fwd"}
    text = {p.name: p.read_text() for p in build.sources()}
    assert 'extern "C" int flash_attention_sm90_fwd(' in text[
        "flash_attention_sm90.cu"]
    assert 'extern "C" int flash_attention_fwd(' in text["flash_attention.cu"]
    assert "wgmma.mma_async" in (build.CSRC / "sm90.cuh").read_text()


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


@pytest.mark.parametrize("ptr,d,size,want", [
    (0, 128, 2, (8, 8, True)),       # q_norm / k_norm rows, bf16
    (0, 128, 4, (4, 16, True)),
    (0, 1024, 2, (8, 64, True)),     # qwen residual norms
    (0, 2048, 2, (8, 128, True)),    # xlstm
    (0, 2048, 4, (4, 256, True)),
    (256, 100, 4, (4, 16, True)),    # fp32 d=100 is a multiple of 4
    (0, 100, 2, (1, 64, True)),      # a tail: scalar loads
    (8, 1024, 2, (1, 256, False)),   # 8-byte aligned: scalar, streamed
    (200, 100, 2, (1, 64, True)),    # x[1:] of a [rows, 100] bf16 tensor
    (4, 128, 4, (1, 64, True)),
    (0, 65536, 2, (8, 256, False)),  # too wide for registers: streamed
    (0, 8, 2, (8, 1, True)),         # one unit: one thread
])
def test_rmsnorm_plan(ptr, d, size, want):
    assert rmsnorm_plan(ptr, d, size) == want


@pytest.mark.parametrize("size", [2, 4])
def test_rmsnorm_plan_covers_every_row(size):
    """Vector loads only where aligned and d divides; one row per group of
    at most 256 threads (a power of two); two units per thread hold the
    whole row, or the row is streamed."""
    for d in list(range(1, 300)) + [1000, 1024, 2048, 4096, 5504, 16384]:
        for ptr in (0, 8, 16, 4, 2):
            vec, group, held = rmsnorm_plan(ptr, d, size)
            aligned = ptr % 16 == 0 and d % (16 // size) == 0
            assert vec == (16 // size if aligned else 1)
            assert group & (group - 1) == 0 and 1 <= group <= 256
            assert isinstance(held, bool)
            if held:
                assert group * 2 * vec >= d
                assert group * 2 * vec < 2 * d or group == 1
            else:
                assert group == 256 and 256 * 2 * vec < d


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


def _ssd_chunked_emulation(x, a, B, C, *, initial_state=None,
                           norm_weights=None, initial_norm_state=None):
    """The CUDA kernel's chunked arithmetic in plain torch, step for step:
    chunks of ``CHUNK`` steps, the last padded with decay 1 (a = 0), B = C =
    0 and x = 0; the normalizer as one more column whose input is w. Per
    chunk the decay exponents are sums of a taken in order over exactly the
    steps they span (seg[i, j] = a[j+1] + ... + a[i], never a difference of
    two cumulative sums), M is computed first with the exponent taken only
    where i >= j, then y = exp(a_cum) * (C . S_old) + M . X and
    S = exp(a_tot) * S_old + B^T . (X * exp(seg[L-1, :]))."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    L = ssd_module.CHUNK
    nc = -(-T // L)
    pad = nc * L - T
    norm = norm_weights is not None
    X = x.float()
    S = (torch.zeros(b, H, N, P) if initial_state is None
         else initial_state.float())
    if norm:
        X = torch.cat([X, norm_weights.float()[..., None]], dim=-1)
        Sn = (torch.zeros(b, H, N) if initial_norm_state is None
              else initial_norm_state.float())
        S = torch.cat([S, Sn[..., None]], dim=-1)

    def chunked(t):                         # [b,T,H,...] -> [b,H,nc,L,...]
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, nc, L, H, *t.shape[3:])
        return t.movedim(3, 1)

    X, Bc, Cc = chunked(X), chunked(B.float()), chunked(C.float())
    A = chunked(a.float()[..., None])[..., 0]
    below = torch.ones(L, L, dtype=torch.bool).tril()
    seg = torch.zeros(b, H, nc, L, L)       # seg[..., i, j], i >= j
    for i in range(1, L):                   # one add per step, in order
        seg[..., i, :i] = seg[..., i - 1, :i] + A[..., i, None]
    a_cum = A.clone()                       # a[0] + ... + a[i], in order
    for i in range(1, L):
        a_cum[..., i] = a_cum[..., i - 1] + A[..., i]
    M = torch.where(below, (Cc @ Bc.transpose(-1, -2)) * torch.exp(seg), 0.0)
    ys = []
    for c in range(nc):
        ys.append(torch.exp(a_cum[:, :, c])[..., None] * (Cc[:, :, c] @ S)
                  + M[:, :, c] @ X[:, :, c])
        Xd = X[:, :, c] * torch.exp(seg[:, :, c, L - 1])[..., None]
        S = (torch.exp(a_cum[:, :, c, -1:])[..., None] * S
             + Bc[:, :, c].transpose(-1, -2) @ Xd)
    y = torch.stack(ys, dim=2).reshape(b, H, nc * L, -1)[:, :, :T]
    y = y.movedim(1, 2)                     # [b,T,H,P(+1)]
    if not norm:
        return y.to(x.dtype), S
    return y[..., :P].to(x.dtype), y[..., P], S[..., :P], S[..., P]


def _ssd_model_like(seed, b, T, H, N, P, gate_shift=0.0):
    """mLSTM inputs as the model draws them: log forget gates
    logsigmoid(N(3, 1)) (slow forgetting), input gates
    w = exp(clamp(N(-2, 1) + gate_shift, max=15)) (the model's clamp; a
    shift of 15 puts w at ~1e6, where the clamp bites), x = v * w,
    B = k / sqrt(N), C = q."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    a = torch.nn.functional.logsigmoid(f32(b, T, H) + 3)
    w = torch.exp(torch.clamp(f32(b, T, H) - 2 + gate_shift, max=15))
    x = f32(b, T, H, P) * w[..., None]
    return x, a, f32(b, T, H, N) / math.sqrt(N), f32(b, T, H, N), w


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 137, 300])
def test_ssd_chunked_emulation_vs_plain(T, init, norm):
    """The kernel's chunked arithmetic against the sequential recurrence:
    ragged tails, one step, exact chunks, state in and out, normalizer."""
    b, H, N, P = 2, 2, 16, 24
    _, (x, B, C, S0, w, Sn0) = _inputs(
        14, (b, T, H, P), (b, T, H, N), (b, T, H, N), (b, H, N, P),
        (b, T, H), (b, H, N), scale=0.5)
    a = torch.from_numpy(_log_decay(15, b, T, H))
    kw = {}
    if init:
        kw["initial_state"] = S0
    if norm:
        kw["norm_weights"] = torch.exp(w - 2)
        if init:
            kw["initial_norm_state"] = Sn0
    got = _ssd_chunked_emulation(x, a, B, C, **kw)
    want = ssd_scan_ref(x, a, B, C, **kw)
    assert len(got) == len(want) == (4 if norm else 2)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        _close(g, w_.numpy(), TOL["float32"])


@pytest.mark.parametrize("gate_shift", [0.0, 15.0])
@pytest.mark.parametrize("T", [137, 300])
def test_ssd_chunked_emulation_model_like_inputs(T, gate_shift):
    """Slow forgetting (a ~ -0.05, the served model's b_f = 3) carries state
    across many chunks; exponential input gates make x and w large. At
    w ~ 1e6 outputs that cancel to near 0 carry the rounding of terms of
    ~1e6 in either summation order, so there each output is held to 2e-5
    of its tensor's largest magnitude (the fp32 error is ~1e-6 of it)."""
    x, a, B, C, w = _ssd_model_like(16, 1, T, 2, 32, 16, gate_shift)
    S0 = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (1, 2, 32, 16)).astype(np.float32))
    kw = dict(initial_state=S0, norm_weights=w)
    got = _ssd_chunked_emulation(x, a, B, C, **kw)
    for g, w_ in zip(got, ssd_scan_ref(x, a, B, C, **kw)):
        if gate_shift:
            scale = float(w_.abs().max())
            assert scale > 1e5
            assert float((g - w_).abs().max()) <= TOL["float32"] * scale
        else:
            _close(g, w_.numpy(), TOL["float32"])


def test_ssd_chunked_emulation_vs_ssd_chunked():
    """Against the JAX package's chunk-parallel form at a T it takes."""
    b, T, H, N, P = 1, 256, 2, 16, 32
    (jx, jB, jC, jS, jw, jSn), (tx, tB, tC, tS, tw, tSn) = _inputs(
        18, (b, T, H, P), (b, T, H, N), (b, T, H, N), (b, H, N, P), (b, T, H),
        (b, H, N), scale=0.5)
    a = _log_decay(19, b, T, H)
    want = jax_ssd_chunked(jx, jnp.asarray(a), jB, jC, 64, initial_state=jS,
                           norm_weights=jw, initial_norm_state=jSn)
    got = _ssd_chunked_emulation(tx, torch.from_numpy(a), tB, tC,
                                 initial_state=tS, norm_weights=tw,
                                 initial_norm_state=tSn)
    for g, w_ in zip(got, want):
        _close(g, w_, TOL["float32"])


def test_ssd_chunk_constant_matches_the_kernel():
    src = (build.CSRC / "ssd_scan.cu").read_text()
    assert f"constexpr int kChunk = {ssd_module.CHUNK};" in src


def test_ssd_shape_rule_constants_match_the_kernels():
    """The constants behind ``fwd_workspace_floats`` / ``bwd_workspace_
    floats``, the wrapper's one copy of the C entries' sizes and refusals."""
    fwd = (build.CSRC / "ssd_scan.cu").read_text()
    bwd = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    for name, value in (("kTile", ssd_module.WALK_TILE),
                        ("kSumBlock", ssd_module.SUM_BLOCK),
                        ("kSmallState", ssd_module.SMALL_STATE)):
        assert f"constexpr int {name} = {value};" in fwd
    assert f"constexpr int kT = {ssd_module.BWD_TILE};" in bwd
    assert "constexpr int kThreads = 256;" in bwd
    assert "constexpr int kPassElems = 4 * kThreads;" in bwd
    assert ssd_module.BWD_PASS_ELEMS == 4 * 256
    limit = str(ssd_module.GRID_LIMIT)
    assert fwd.count(f">= {limit}") == 3 and bwd.count(f"<= {limit}") == 2


@pytest.mark.parametrize("route,shape", [
    ("walk", (1, 64 * 65534, 1, 1, 64, 32)),
    ("chunks", (13106, 64, 4, 1, 64, 64)),
    ("chunks", (1, 64, 4, 1, 64, 64))])
def test_ssd_fwd_workspace_accepts_to_the_edge(route, shape):
    assert ssd_module.fwd_workspace_floats(route, *shape) > 0


@pytest.mark.parametrize("route,shape", [
    ("walk", (1, 64 * 65534 + 1, 1, 1, 64, 32)),
    ("walk", (1, 64, 1, 1, 64, 32 * 65534 + 1)),
    ("walk", (1, 64, 3, 2, 64, 32)),
    ("chunks", (13107, 64, 4, 1, 64, 64)),
    ("chunks", (1, 64, 4, 1, 12, 64)),
    ("chunks", (1, 64, 4, 1, 64, 65))])
def test_ssd_fwd_workspace_refuses_what_the_entries_refuse(route, shape):
    with pytest.raises(RuntimeError, match="invalid argument"):
        ssd_module.fwd_workspace_floats(route, *shape)


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


@pytest.mark.parametrize("B,nh,dh,r_dtype", [
    (2, 2, 16, torch.float32),    # chip_smoke.py SLSTM_GRID
    (1, 4, 32, torch.float32),
    (3, 1, 64, torch.float32),
    (2, 2, 16, torch.bfloat16),
    (1, 4, 512, torch.bfloat16),  # the served sLSTM layer (xlstm-1.3b)
    (16, 4, 512, torch.bfloat16),
    (1, 4, 512, torch.float32),   # fp32 weights: rows beyond shared memory
    (16, 4, 512, torch.float32),
    (4, 4, 512, torch.bfloat16),
    (1, 1, 48, torch.bfloat16),   # dh not a multiple of 32: 16 units
])
def test_slstm_plan(B, nh, dh, r_dtype):
    """One cluster of G <= 16 blocks per head, G dividing dh; units and
    segments as the dot's layout needs them; shared memory within the
    card's 232,448 bytes per block; the bf16 slice whole in shared memory,
    an fp32 one at dh = 512 with an L2 tail of whole warps' rows."""
    plan = slstm_module.slstm_plan(B, nh, dh, r_dtype)
    assert 1 <= plan.blocks <= 16 and plan.blocks * plan.units == dh
    assert plan.units in (16, 32)
    groups = plan.units // 2                       # 8-column groups
    threads = plan.segments * groups
    assert threads % 32 == 0 and threads <= slstm_module.THREADS
    assert plan.segments & (plan.segments - 1) == 0
    assert dh % (4 * plan.segments) == 0           # rows come in float4s
    assert plan.tile == (1 if B == 1 else slstm_module.TILE)
    assert plan.smem_bytes + slstm_module.BARRIER_BYTES <= 232_448
    warp_rows = 32 // groups * (dh // plan.segments)
    assert plan.resident_rows % warp_rows == 0
    if r_dtype == torch.bfloat16:
        assert plan.resident_rows == dh
    elif dh == 512:
        assert 0 < plan.resident_rows < dh
        # nothing that fits is left out: one more warp's rows would not fit
        more = plan.smem_bytes + warp_rows * 4 * plan.units * 4
        assert more + slstm_module.BARRIER_BYTES > 232_448


def test_slstm_plan_at_the_served_shape():
    bf16 = slstm_module.slstm_plan(1, 4, 512, torch.bfloat16)
    assert bf16 == (16, 32, 16, 1, 512, 512 * 128 * 2 + 2 * 512 * 4
                    + 8 * 128 * 4 + 3 * 32 * 4)
    assert slstm_module.slstm_plan(1, 4, 512, torch.float32).resident_rows \
        == 384


@pytest.mark.parametrize("B,nh,dh,r_dtype,reason", [
    (1, 4, 1024, torch.bfloat16, "more than a cluster's 16"),
    (1, 4, 40, torch.bfloat16, "dh % 16 == 0"),
    (17, 4, 64, torch.float32, "B <= 16"),
    (0, 4, 64, torch.float32, "1 <= B"),
    (1, 4, 64, torch.float16, "float32 or bfloat16"),
])
def test_slstm_plan_refuses_what_the_kernel_cannot_take(B, nh, dh, r_dtype,
                                                        reason):
    with pytest.raises(ValueError, match=reason):
        slstm_module.slstm_plan(B, nh, dh, r_dtype)


def test_slstm_constants_match_the_kernel():
    src = (build.CSRC / "slstm_scan.cu").read_text()
    for name, value in (("kThreads", slstm_module.THREADS),
                        ("kTile", slstm_module.TILE),
                        ("kMaxBatch", slstm_module.MAX_BATCH),
                        ("kMaxCluster", slstm_module.MAX_CLUSTER),
                        ("kMaxSmem", slstm_module.SMEM_MAX),
                        ("kBarrierBytes", slstm_module.BARRIER_BYTES)):
        assert f"constexpr int {name} = {value};" in src


def _c_params(src, name):
    sig = src[src.index(f'extern "C" int {name}('):]
    return sig[:sig.index(")")].count(",") + 1


def test_slstm_kernel_is_a_cluster_launch_without_a_grid_barrier():
    """One cluster per head through cudaLaunchKernelEx, h exchanged in
    distributed shared memory; no cooperative launch, counters, spin,
    fences or device-memory h buffer; the C entries take what the wrapper
    passes."""
    src = (build.CSRC / "slstm_scan.cu").read_text()
    src += (build.CSRC / "slstm.cuh").read_text()   # its cluster helpers
    for used in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "cudaFuncAttributeNonPortableClusterSizeAllowed",
                 "st.async.shared::cluster", "barrier.cluster.arrive",
                 "cudaOccupancyMaxActiveClusters"):
        assert used in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for gone in ("cudaLaunchCooperativeKernel", "__threadfence", "atomicAdd",
                 "hbuf", "counters", "volatile int"):
        assert gone not in code
    assert _c_params(src, "slstm_scan_fwd") == len(slstm_module._ARGTYPES)
    assert _c_params(src, "slstm_scan_max_clusters") == len(
        slstm_module._OCC_ARGTYPES)


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


class _Elsewhere(torch.Tensor):
    """A tensor on a device with no kernel and no plain version (an XPU's:
    shape and dtype only; any op on it raises). ``meta`` is no longer
    such a device: the wrappers evaluate it abstractly for the dry-run."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a device with no kernel")


def test_other_devices_raise():
    q = _Elsewhere(1, 8, 4, 32)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm(q, _Elsewhere(32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_rejects_a_view_off_16_byte_alignment(dtype):
    """Both kernels copy q, k and v in 16-byte pieces (cp.async, TMA): a
    contiguous view one element into its buffer raises, never falls back."""
    flat = torch.zeros(1 + 2 * 8 * 4 * 32, dtype=dtype)
    aligned = flat[:-1].view(2, 8, 4, 32)
    off = flat[1:].view(2, 8, 4, 32)
    assert aligned.data_ptr() % 16 == 0 and off.is_contiguous()
    flash_module._check(aligned, aligned, aligned)
    for args in ((off, aligned, aligned), (aligned, off, aligned),
                 (aligned, aligned, off)):
        with pytest.raises(ValueError, match="not 16-byte aligned"):
            flash_module._check(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_takes_head_dim_80_for_the_forward_only(dtype):
    """Both forwards take hd 32, 64, 80 and 128; the fp32 backward only 32,
    64 and 128, and at hd 80 it raises NotImplementedError naming the
    ROADMAP item before any launch (the C switch never sees the call); the
    bf16 backward also takes hd 80 (zamba2's shared block, on 80-column
    tiles); any other hd is a ValueError."""
    def qkv(hd):
        q = torch.zeros(1, 8, 4, hd, dtype=dtype)
        kv = torch.zeros(1, 8, 2, hd, dtype=dtype)
        return q, kv, kv
    for hd in (32, 64, 80, 128):
        flash_module._check(*qkv(hd))
    for hd in (32, 64, 128):
        flash_module._check(*qkv(hd), backward=True)
    if dtype == torch.bfloat16:
        flash_module._check(*qkv(80), backward=True)
    else:
        with pytest.raises(NotImplementedError,
                           match="head_dim 80 .*ROADMAP.md queue 2 item 1"):
            flash_module._check(*qkv(80), backward=True)
    with pytest.raises(ValueError, match="head_dim 96 not in"):
        flash_module._check(*qkv(96))


def test_c_switches_take_the_head_dims_the_wrapper_takes():
    """Each forward's C entries have a case for every hd of
    ``_FWD_HEAD_DIMS``; the fp32 backward's for those of its dtype's
    ``_BWD_HEAD_DIMS`` only (its kernels assert a tile width equal to
    hd)."""
    for name, dims in (("flash_attention.cu", flash_module._FWD_HEAD_DIMS),
                       ("flash_attention_sm90.cu",
                        flash_module._FWD_HEAD_DIMS),
                       ("flash_attention_bwd.cu",
                        flash_module._BWD_HEAD_DIMS[torch.float32])):
        code = _code(name)
        cases = {int(n) for n in re.findall(r"case (\d+):", code)}
        assert cases == set(dims), (name, cases)
        for hd in dims:
            assert code.count(f"case {hd}:") == 2, (name, hd)


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
    x = _Elsewhere(1, 8, 2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(x, _Elsewhere(1, 8, 2), x, x)
    with pytest.raises(ValueError, match="no kernel"):
        slstm_scan(_Elsewhere(1, 8, 2, 64), _Elsewhere(2, 16, 64),
                   _Elsewhere(2, 64))


def test_build_compiles_the_scan_kernels():
    names = {p.name for p in build.sources()}
    assert {"ssd_scan.cu", "slstm_scan.cu"} <= names


def test_build_compiles_the_tensor_core_flash_kernel():
    names = {p.name for p in build.sources()}
    assert "flash_attention_sm90.cu" in names
    assert (build.CSRC / "sm90.cuh").exists()   # hashed into the library name


# --------------------------------------------------------------------------
# backward of flash_attention and rmsnorm (the member step's gradients)
# --------------------------------------------------------------------------
BWD_TOL = 2e-5        # fp32, relative to each gradient's largest magnitude
FLASH_BWD_CASES = [   # B, T, S, H, KV, hd, window, q_offset
    (2, 16, 16, 4, 2, 32, 0, 0),       # the sweep member's attention, GQA
    (1, 37, 37, 4, 2, 32, 0, 0),       # ragged T
    (1, 70, 70, 2, 1, 64, 0, 0),       # two tiles, a ragged second one
    (1, 21, 50, 4, 2, 32, 0, 29),      # q_offset (cross lengths)
    (1, 40, 40, 4, 4, 32, 8, 0),       # window
    (1, 9, 9, 4, 1, 128, 0, 0),        # the full width's head_dim
]


@pytest.fixture
def saved_launches():
    """Launch counts as they were before the test, restored after it."""
    before = LAUNCHES.copy()
    yield LAUNCHES
    LAUNCHES.clear()
    LAUNCHES.update(before)


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B,T,S,H,KV,hd,window,q_offset", FLASH_BWD_CASES)
def test_flash_bwd_ref_vs_jax_vjp(B, T, S, H, KV, hd, window, q_offset):
    """The plain backward's explicit formulas against jax.vjp of the JAX
    package's ``attend_naive``, on the same inputs and output gradient."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        20, (B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, T, H, hd))
    out, vjp = jax.vjp(lambda q, k, v: jax_attend_naive(
        q, k, v, causal=True, window=window, q_offset=q_offset), jq, jk, jv)
    want = vjp(jdo)
    o, lse = flash_attention_ref(tq, tk, tv, window=window, q_offset=q_offset,
                                 with_lse=True)
    _close(o, out, TOL["float32"])
    assert lse.shape == (B, H, T) and torch.isfinite(lse).all()
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, window=window,
                                  q_offset=q_offset)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == torch.float32
        assert _rel_max(g.numpy(), w) < BWD_TOL


@pytest.mark.parametrize("B,T,S,H,KV,hd,window,q_offset",
                         FLASH_BWD_CASES + [(1, 8, 8, 2, 1, 32, 0, -3)])
def test_flash_function_cpu_vs_autograd_of_plain(B, T, S, H, KV, hd, window,
                                                 q_offset, saved_launches):
    """On CPU tensors the autograd Function runs the plain forward and the
    plain backward; its gradients equal autograd's through the plain
    forward, rows with no visible key (q_offset < 0) included, and it
    launches nothing."""
    _, tensors = _inputs(21, (B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                         (B, T, H, hd))
    q, k, v, do = tensors
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kw = dict(causal=True, window=window, q_offset=q_offset)
    saved_launches.clear()
    out = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    assert sum(saved_launches.values()) == 0
    want_out = flash_attention_ref(*ref_leaves, **kw)
    want = torch.autograd.grad(want_out, ref_leaves, do)
    assert torch.equal(out.detach(), want_out.detach())
    for g, w in zip(got, want):
        assert _rel_max(g.numpy(), w.numpy()) < BWD_TOL
    if q_offset < 0:                       # rows 0..2 see no key
        assert torch.all(got[0][:, :-q_offset] == 0)


@pytest.mark.parametrize("shape", [(2, 16, 128), (2, 16, 4, 32), (3, 1024),
                                   (5, 100)])
def test_rmsnorm_bwd_ref_vs_jax_vjp(shape):
    """dx and dg of the explicit formulas against jax.vjp of the JAX
    package's ``rms_norm``, at the member step's widths (d_model 128, head
    dim 32), the full width's 1024 and a tail."""
    d = shape[-1]
    (jx, jdy), (tx, tdy) = _inputs(22, shape, shape)
    g = (1 + 0.1 * np.random.default_rng(23).standard_normal(d)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda x, g_: jax_rms_norm(x, g_, 1e-6), jx,
                     jnp.asarray(g))
    want_dx, want_dg = vjp(jdy)
    dx, dg = rmsnorm_bwd_ref(tx, torch.from_numpy(g), tdy, eps=1e-6)
    assert dx.shape == tx.shape and dg.shape == (d,)
    assert _rel_max(dx.numpy(), want_dx) < BWD_TOL
    assert _rel_max(dg.numpy(), want_dg) < BWD_TOL


@pytest.mark.parametrize("shape", [(2, 16, 128), (2, 16, 4, 32), (7, 100)])
def test_rmsnorm_function_cpu_vs_autograd_of_plain(shape, saved_launches):
    d = shape[-1]
    _, (x, dy, g) = _inputs(24, shape, shape, (d,))
    g = 1 + 0.1 * g
    leaves = [x.clone().requires_grad_(True), g.clone().requires_grad_(True)]
    ref_leaves = [x.clone().requires_grad_(True),
                  g.clone().requires_grad_(True)]
    saved_launches.clear()
    out = ops.norm(*leaves, eps=1e-6)
    got = torch.autograd.grad(out, leaves, dy)
    assert sum(saved_launches.values()) == 0
    want_out = rmsnorm_ref(*ref_leaves, eps=1e-6)
    want = torch.autograd.grad(want_out, ref_leaves, dy)
    assert torch.equal(out.detach(), want_out.detach())
    for got_t, want_t in zip(got, want):
        assert _rel_max(got_t.numpy(), want_t.numpy()) < BWD_TOL


def test_no_grad_calls_skip_the_functions():
    """Serving (no input requires grad) calls the forward directly, as
    before the backward existed; the Functions are used only for grads."""
    _, (q, k, v, x) = _inputs(25, (1, 9, 4, 32), (1, 9, 2, 32),
                              (1, 9, 2, 32), (3, 128))
    assert flash_attention(q, k, v).grad_fn is None
    assert rmsnorm(x, torch.ones(128)).grad_fn is None
    q.requires_grad_(True)
    x.requires_grad_(True)
    assert type(flash_attention(q, k, v).grad_fn).__name__ == \
        "FlashAttentionBackward"
    assert type(rmsnorm(x, torch.ones(128)).grad_fn).__name__ == \
        "RMSNormBackward"
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


def test_backward_wrappers_raise_on_other_devices():
    q = _Elsewhere(1, 8, 4, 32)
    lse = _Elsewhere(1, 4, 8)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm_bwd(q, _Elsewhere(32), q)


@pytest.mark.parametrize("entry,source,argtypes", [
    ("flash_attention_fwd", "flash_attention.cu",
     flash_module._ARGTYPES["flash_attention_fwd"]),
    ("flash_attention_sm90_fwd", "flash_attention_sm90.cu",
     flash_module._ARGTYPES["flash_attention_sm90_fwd"]),
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     flash_module._BWD_ARGTYPES),
    ("flash_attention_bwd_occupancy", "flash_attention_bwd.cu",
     flash_module._OCC_ARGTYPES),
    ("rmsnorm_fwd", "rmsnorm.cu", rms_module._ARGTYPES),
    ("rmsnorm_bwd", "rmsnorm_bwd.cu", rms_module._BWD_ARGTYPES),
    ("flash_attention_fwd_occupancy", "flash_attention.cu",
     flash_module._OCC_ARGTYPES),
    ("flash_attention_sm90_occupancy", "flash_attention_sm90.cu",
     flash_module._OCC_ARGTYPES),
])
def test_c_entries_take_what_the_wrappers_pass(entry, source, argtypes):
    """Each C entry is defined by its source and takes as many arguments as
    its wrapper declares (ctypes would not notice a mismatch)."""
    assert source in {p.name for p in build.sources()}
    assert _c_params((build.CSRC / source).read_text(), entry) == len(argtypes)


def _code(name):
    """A CUDA source without its comments."""
    return "\n".join(line.split("//")[0] for line in
                     (build.CSRC / name).read_text().splitlines())


def test_backward_kernels_are_deterministic_and_write_lse():
    """No float atomics in the backward kernels (fixed summation order),
    and the fp32 forward writes +inf lse for a row with no visible key
    (l == 0), m + log(l) otherwise, from the row's running max and sum."""
    for name in ("flash_attention_bwd.cu", "rmsnorm_bwd.cu"):
        assert "atomic" not in _code(name)
    assert ("l_row == 0.f ? CUDART_INF_F : m_row + logf(l_row)"
            in _code("flash_attention.cu"))


def test_flash_bwd_kernels_copy_tiles_asynchronously():
    """The backward's tiles come in by 16-byte cp.async, double-buffered and
    waited for before the block barrier; each kernel is one block of 16
    warps per SM; the products stay on the CUDA cores (no mma, no wgmma).
    The copies and NT live in the header the source includes."""
    code = _code("flash_attention_bwd.cu") + _code("flash_tiles.cuh")
    for used in ("cp.async.cg.shared.global", "cp.async.commit_group",
                 "cp.async.wait_group 0", "constexpr int NT = 512;",
                 "__launch_bounds__(NT, 1)", "buf ^ 1"):
        assert used in code
    for gone in ("mma", "wgmma", "tf32", "atomic"):
        assert gone not in code.lower()


def test_flash_fwd_kernel_copies_tiles_asynchronously():
    """The fp32 forward's tiles come in by 16-byte cp.async, k and v
    double-buffered (single-buffered at hd 192, each cp.async group waited
    for in turn); one block of 16 warps per SM; the products stay on the
    CUDA cores, with no atomics; the two halves each sum S over chunks
    4r..4r+3 of every 32 floats of d, as the emulation above does; P V
    over G column groups (three at hd 192); both flash sources build on
    the shared header; the kernel keeps the name that chip_smoke.py finds
    in its traces."""
    code = _code("flash_attention.cu")
    for used in ("cp_async_commit()", "cp_async_wait_all()",
                 "cp_async_wait<1>()", "L::NBUF == 1",
                 "load_tile<HD, true>", "load_tile<HD, false>",
                 "__launch_bounds__(NT, 1)", "buf ^ 1",
                 "rows_dot_rows<HD, 4>(", "4 * role)",
                 "cols_by_rows<HD, M, true, true, G>", "expf(sv[c] - m_new)",
                 "flash_fwd_kernel<HD><<<"):
        assert used in code, used
    for gone in ("mma", "wgmma", "tf32", "atomic", "exp2"):
        assert gone not in code.lower()
    tiles = _code("flash_tiles.cuh")
    for used in ("cp.async.cg.shared.global", "cp.async.commit_group",
                 "cp.async.wait_group 0", "cp.async.wait_group %0",
                 "constexpr int NT = 512;"):
        assert used in tiles
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "flash_tiles.cuh"' in _code(name)
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert smoke.count('"flash_fwd_kernel') >= 2


@pytest.mark.parametrize("rows,d,sms", [(2048, 1024, 132), (32768, 128, 132),
                                        (256, 32, 132), (1, 128, 132),
                                        (1000, 100, 4)])
def test_rmsnorm_bwd_blocks(rows, d, sms):
    """At most 4 blocks per SM, each with the same number of row groups
    (to one), every row group covered."""
    _, group, _ = rmsnorm_plan(0, d, 4)
    per_block = 256 // group
    groups = -(-rows // per_block)
    blocks = rmsnorm_bwd_blocks(rows, group, sms)
    assert 1 <= blocks <= min(groups, 4 * sms)
    rounds = -(-groups // blocks)
    assert blocks * rounds >= groups and (blocks - 1) * rounds < groups


def test_flash_bwd_check_sees_a_dropped_key_tile():
    """``chip_smoke.py``'s gradient check at a member-step shape: the plain
    backward passes it against autograd of the plain forward, and the same
    backward run without the first 64 keys (q_offset -64) fails it."""
    smoke = _chip_smoke()
    _, (q, k, v, do) = _inputs(26, (1, 137, 4, 32), (1, 137, 2, 32),
                               (1, 137, 2, 32), (1, 137, 4, 32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves), leaves, do)
    o, lse = flash_attention_ref(q, k, v, with_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do)
    smoke.check_grads("flash_attention_bwd", "T=137", got, want)
    o, lse = flash_attention_ref(q, k[:, 64:], v[:, 64:], q_offset=-64,
                                 with_lse=True)
    dq, dk, dv = flash_attention_bwd_ref(q, k[:, 64:], v[:, 64:], o, lse, do,
                                         q_offset=-64)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 64, 0))
    with pytest.raises(RuntimeError, match="disagrees with autograd"):
        smoke.check_grads("flash_attention_bwd", "T=137, first tile dropped",
                          (dq, pad(dk), pad(dv)), want)

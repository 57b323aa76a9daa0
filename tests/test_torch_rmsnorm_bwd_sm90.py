"""The bf16 rmsnorm backward of ``csrc/rmsnorm_bwd_sm90.cu`` on the CPU.

The kernel runs only on the card (``chip_smoke.py`` phase 4 holds it
against ``rmsnorm_bwd_ref`` there). Here:

- the wrapper's layout (``rmsnorm.bwd_plan``: blocks, clusters, rows per
  block, shared memory) covers every row exactly once and fits a block's
  227 KB, at the Trainer's norm shapes and a grid of (rows, d) with odd d
  and views off 16-byte alignment;
- a plain emulation of the kernel's fixed dg order (per thread over its
  slot's rows, the block's slots, the cluster's blocks in rank order, the
  clusters) against ``rmsnorm_bwd_ref`` in fp32, within the bound of any
  fp32 summation order: (n - 1) * 2^-24 * sum |term| for n terms, twice
  (both sides), plus each term's own rounding; after the one rounding to
  bf16, against ``jax.vjp`` of ``repro.models.common.rms_norm`` in bf16,
  within twice JAX's own bf16 distance from its fp32 result, as
  ``tests/test_torch_bf16_grads.py`` holds the plain formulas;
- the C entry against the wrapper's argument types, the source's constants
  against the wrapper's, no atomics, and kernel names the trace groups find.
"""
from __future__ import annotations

import ctypes
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels import build, rmsnorm_bwd_ref

rms = importlib.import_module("repro_torch.kernels.rmsnorm")

SOURCE = build.CSRC / "rmsnorm_bwd_sm90.cu"
TRAINER_SHAPES = [(2048, 1024), (32768, 128), (16384, 128)]   # rows, d
STATIC_SMEM = 8 + 2 * 2 * 8 * 4    # an mbarrier and the group sums
H100_CLUSTERS = 66   # clusters of 2 an H100 holds at one block an SM
PLAN_GRID = TRAINER_SHAPES + [
    (2048, 5120), (1, 128), (4, 1024), (1000, 100), (1001, 33), (7, 8),
    (3, 8192), (5, 8200), (256, 32), (300, 128), (129, 2048), (64, 4096),
    (100, 30000)]


def _passes(p: rms.BwdPlan, rows: int):
    """(block, first row, rows) of each pass of the kernel's blocks over
    their bands, in order: slot k of a pass takes its first row + k."""
    slots = rms.BWD_THREADS // p.group
    for b in range(p.blocks):
        r0 = min(rows, b * p.rows_per_block)
        r1 = min(rows, r0 + p.rows_per_block)
        for base in range(r0, r1, slots):
            yield b, base, min(slots, r1 - base)


def _coverage(p: rms.BwdPlan, rows: int) -> np.ndarray:
    """How many times the kernel's passes reach each row."""
    seen = np.zeros(rows, np.int64)
    for _, base, n in _passes(p, rows):
        seen[base:base + n] += 1
    return seen


@pytest.mark.parametrize("max_clusters", [H100_CLUSTERS, 16, 2, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,d", PLAN_GRID)
def test_bwd_plan_covers_every_row_once_and_fits(rows, d, aligned,
                                                 max_clusters):
    p = rms.bwd_plan(0 if aligned else 2, rows, d, max_clusters)
    slots = rms.BWD_THREADS // p.group
    recv = rms.BWD_CLUSTER * -(-d // rms.BWD_CLUSTER) * 4 * (p.vec == 8)
    assert p.vec == (8 if aligned and d % 8 == 0 and d <= 8192 else 1)
    assert p.group & (p.group - 1) == 0 and 1 <= p.group <= rms.BWD_THREADS
    assert p.blocks == p.clusters * rms.BWD_CLUSTER
    assert 1 <= p.clusters <= min(max_clusters, rms.BWD_MAX_CLUSTERS)
    assert (_coverage(p, rows) == 1).all()
    assert recv < p.smem <= rms.BWD_SMEM_MAX
    assert rms.BWD_SMEM_MAX + STATIC_SMEM <= 227 * 1024
    if p.vec == 8:
        units = d // 8
        assert 8 <= p.group and -(-units // p.group) <= rms.BWD_MAX_UNITS
        n_rows = 8 if p.group < 32 else slots       # the warps' or slots'
        assert p.smem == n_rows * d * 4 + recv
    else:
        assert p.smem == slots * d * 4


@pytest.mark.parametrize("rows,d", TRAINER_SHAPES)
def test_bwd_plan_keeps_a_band_in_flight_at_the_trainer_shapes(rows, d):
    """On an H100: the 16-byte path, the 66 clusters of 2 blocks it holds
    at once (one wave, a block on each of its 132 SMs), the bands as even
    as whole rows make them."""
    p = rms.bwd_plan(0, rows, d, H100_CLUSTERS)
    assert (p.vec, p.clusters, p.blocks) == (8, 66, 132)
    assert p.rows_per_block == -(-rows // p.blocks)


def test_bwd_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="too wide"):
        rms.bwd_plan(2, 16, 60000, H100_CLUSTERS)


def emulate(x, g, dy, p: rms.BwdPlan, eps: float = 1e-6):
    """The kernel's dx and fp32 dg (before the rounding) in numpy fp32, dg
    summed in the kernel's order: each slot over its rows in order; on the
    16-byte path with G < 32 the slots of a warp by a butterfly (xor G,
    2G, ...), then the block's warps in order, else the block's slots in
    order; the cluster's blocks by rank; the clusters by the dg kernel's
    warps (warp w: clusters w, w + 8, ... in order), the warps in order."""
    f = np.float32
    rows, d = x.shape
    r = f(1) / np.sqrt((x * x).sum(-1, dtype=f) / f(d) + f(eps))
    c = r * r * r * (((g * dy) * x).sum(-1, dtype=f) / f(d))
    dx = r[:, None] * (g * dy) - x * c[:, None]
    term = (dy * x) * r[:, None]
    slots = rms.BWD_THREADS // p.group
    acc = np.zeros((p.blocks, slots, d), f)
    for b, base, n in _passes(p, rows):
        acc[b, :n] += term[base:base + n]
    if p.vec == 8 and p.group < 32:           # 32 / G slots a warp
        per_warp = 32 // p.group
        warps = acc.reshape(p.blocks, slots // per_warp, per_warp, d)
        while warps.shape[2] > 1:              # slot i + slot (i ^ 1), ...
            warps = warps[:, :, 0::2] + warps[:, :, 1::2]
        acc = warps[:, :, 0]
    block = acc[:, 0].copy()
    for k in range(1, acc.shape[1]):
        block += acc[:, k]
    ranks = block.reshape(p.clusters, rms.BWD_CLUSTER, d)
    cluster = ranks[:, 0].copy()
    for k in range(1, rms.BWD_CLUSTER):
        cluster += ranks[:, k]
    warps = []                                 # warp w: clusters w, w + 8, ...
    for w in range(min(8, p.clusters)):
        s = cluster[w].copy()
        for k in range(w + 8, p.clusters, 8):
            s += cluster[k]
        warps.append(s)
    dg = warps[0]
    for s in warps[1:]:
        dg += s
    return dx.astype(f), dg, term


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x, dy = (_bf16(rng.standard_normal((rows, d), np.float32))
             for _ in range(2))
    g = _bf16(1 + 0.1 * rng.standard_normal(d, np.float32))
    return x, g, dy


@jax.jit
def _rms_vjps(x, g, dy):
    """jax.vjp of ``rms_norm`` in bf16 and in fp32."""
    out = []
    for dtype in (jnp.bfloat16, jnp.float32):
        _, f = jax.vjp(lambda x_, g_: jax_rms_norm(x_, g_, 1e-6),
                       x.astype(dtype), g.astype(dtype))
        out.append(f(dy.astype(dtype)))
    return out


EMULATED = [  # rows, d, ptr (2: off 16-byte alignment), max_clusters
    (300, 128, 0, 2), (96, 1024, 0, 2), (40, 5120, 0, H100_CLUSTERS),
    (515, 32, 0, 2), (100, 100, 0, 2), (130, 128, 2, 2), (33, 8, 0, 16),
    (2000, 128, 0, H100_CLUSTERS), (400, 256, 2, H100_CLUSTERS)]


@pytest.mark.parametrize("rows,d,ptr,max_clusters", EMULATED)
def test_emulated_dg_order_vs_plain_and_jax(rows, d, ptr, max_clusters):
    x, g, dy = _inputs(rows, d, seed=rows + d)
    p = rms.bwd_plan(ptr, rows, d, max_clusters)
    assert p.vec == (8 if ptr == 0 and d % 8 == 0 else 1)
    xf, gf, dyf = (t.float().numpy() for t in (x, g, dy))
    dx, dg, term = emulate(xf, gf, dyf, p)

    want_dx, want_dg = rmsnorm_bwd_ref(*(t.float() for t in (x, g, dy)),
                                       eps=1e-6)
    np.testing.assert_allclose(dx, want_dx.numpy(), rtol=1e-5, atol=1e-5)
    u = 2.0 ** -24
    bound = (2 * (rows - 1) + 3) * u * np.abs(term).astype(np.float64).sum(0)
    err = np.abs(dg.astype(np.float64) - want_dg.numpy())
    assert (err <= bound + 1e-30).all(), float((err - bound).max())

    want16, want32 = _rms_vjps(*(t.float().numpy() for t in (x, g, dy)))
    for name, got, w16, w32 in (("dx", dx, want16[0], want32[0]),
                                ("dg", dg, want16[1], want32[1])):
        got = _bf16(got).double().numpy()
        exact = np.asarray(w32, np.float64)
        jax_err = np.abs(np.asarray(w16.astype(jnp.float32), np.float64)
                         - exact).max()
        assert jax_err > 0, name
        assert np.abs(got - exact).max() <= 2 * jax_err, name


def _entry_params(name):
    """(type, name) of each parameter of the C entry ``name``."""
    text = SOURCE.read_text()
    head = f'extern "C" int {name}('
    sig = text[text.index(head) + len(head):]
    return [(" ".join(a.split()[:-1]), a.split()[-1])
            for a in sig[:sig.index(")")].split(",")]


CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int*": ctypes.c_void_p, "long long": ctypes.c_longlong,
          "int": ctypes.c_int, "float": ctypes.c_float}


def test_c_entries_take_what_the_wrapper_passes():
    """Types one by one (ctypes would not notice a mismatch), and the
    layout in ``BwdPlan``'s order."""
    params = _entry_params("rmsnorm_bwd_bf16")
    assert [CTYPES[t] for t, _ in params] == list(rms._BWD_BF16_ARGTYPES)
    layout = [n for _, n in params[9:13]]
    assert layout == ["vec", "group", "clusters", "rows_per_block"]
    assert all(f in rms.BwdPlan._fields for f in layout)
    params = _entry_params("rmsnorm_bwd_bf16_max_clusters")
    assert [CTYPES[t] for t, _ in params] == list(rms._BWD_OCC_ARGTYPES)


def test_source_constants_match_the_wrapper():
    text = SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)

    assert int(const("NT")) == rms.BWD_THREADS
    assert int(const("CLUSTER")) == rms.BWD_CLUSTER
    assert int(const("MAX_CLUSTERS")) == rms.BWD_MAX_CLUSTERS
    assert int(const("MAX_UNITS")) == rms.BWD_MAX_UNITS
    assert eval(const("SMEM_MAX")) == rms.BWD_SMEM_MAX


def test_source_has_no_atomics_and_kernels_the_trace_finds():
    """No atomics anywhere (one owner per output: two calls, same bits);
    every kernel's name contains ``rmsnorm_bwd``, which ``chip_smoke.py``'s
    trace groups look for, and none contains ``rmsnorm_kernel`` (the
    forward's group)."""
    text = SOURCE.read_text()
    assert "atomic" not in text.lower()
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", text)
    assert sorted(kernels) == ["rmsnorm_bwd_sm90_dg_kernel",
                               "rmsnorm_bwd_sm90_rows_kernel",
                               "rmsnorm_bwd_sm90_scalar_kernel"]
    assert all("rmsnorm_kernel" not in k for k in kernels)
    smoke = (build.CSRC.parents[3] / "chip_smoke.py").read_text()
    assert '"rmsnorm bwd" if "rmsnorm_bwd" in name' in smoke
    assert 'csrc + "rmsnorm_bwd_sm90.cu"' in smoke

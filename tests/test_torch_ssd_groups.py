"""The port's ssd_scan with B and C per group, and the arithmetic of its
chunk-parallel path, on the CPU.

B and C come as [b, T, G, N], G groups dividing H heads, head h reading
group h // (H // G) (``jnp.repeat`` in the JAX package, ``repeat_interleave``
in the port). On a CPU tensor ``ssd_scan`` runs its plain version, which
expands the groups itself; these tests hold it against its own expanded
call (same bits) and against the JAX package's ``ssd_chunked``, which takes
groups too. The CUDA kernels run only on the card (``chip_smoke.py``); here
``_chunks_emulation`` repeats the chunk-parallel path's arithmetic step for
step in plain torch and is held against the sequential recurrence.

Tolerance: fp32 2e-5, as |got - want| <= tol + tol * |want| (the same
recurrence summed in another order), the bound ``chip_smoke.py`` holds the
kernels to.
"""
from __future__ import annotations

import dataclasses
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, ssd_scan, ssd_scan_ref
from repro_torch.models import ssm as TS

TOL = 2e-5
ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")
L = ssd_module.CHUNK
K_BLOCK = 8                       # kSumBlock in csrc/ssd_scan.cu


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _draw(seed, b, T, H, G, N, P):
    """x, a, B, C as ``chip_smoke.py``'s ``mamba2_like_ssd`` draws them,
    from numpy: dt = softplus(N(0, 1) + dt_bias), dt_bias the inverse
    softplus of a per-head log-uniform draw in [1e-3, 1e-1], A = -(1..H),
    a = dt * A (decays to e^-8 per step and beyond on the fast heads),
    x = silu(N(0, 1)) * dt, B and C silu(N(0, 1)) per group."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    u = torch.from_numpy(rng.random(H).astype(np.float32))
    dt0 = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt = F.softplus(f32(b, T, H) + torch.log(torch.expm1(dt0)))
    a = dt * -torch.arange(1, H + 1, dtype=torch.float32)
    x = F.silu(f32(b, T, H, P)) * dt[..., None]
    return x, a, F.silu(f32(b, T, G, N)), F.silu(f32(b, T, G, N))


def _state(seed, b, H, N, P):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, H, N, P)).astype(np.float32))


# --------------------------------------------------------------------------
# groups
# --------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_version_with_groups_gives_the_expanded_bits(G):
    """Grouped B and C give the same bits as the same rows expanded to
    every head (G = H = 4 is the expansion by 1)."""
    b, T, H, N, P = 2, 37, 4, 16, 8
    x, a, B, C = _draw(1, b, T, H, G, N, P)
    S0 = _state(2, b, H, N, P)
    want = ssd_scan_ref(x, a, B.repeat_interleave(H // G, dim=2),
                        C.repeat_interleave(H // G, dim=2), initial_state=S0)
    got = ssd_scan_ref(x, a, B, C, initial_state=S0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_with_groups_vs_ssd_chunked(G, init):
    """CPU tensors through the wrapper against the JAX package's chunked
    form on the same numpy inputs, which takes B and C per group itself."""
    b, T, H, N, P = 1, 128, 4, 16, 32
    x, a, B, C = _draw(3, b, T, H, G, N, P)
    S0 = _state(4, b, H, N, P) if init else None
    want = jax_ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, a, B, C)),
                           64, initial_state=None if S0 is None
                           else jnp.asarray(S0.numpy()))
    got = ssd_scan(x, a, B, C, initial_state=S0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("H,GB,GC", [(4, 3, 3), (4, 8, 8), (6, 4, 4),
                                     (4, 2, 1), (4, 1, 2)])
def test_check_refuses_groups_that_do_not_fit(H, GB, GC):
    """A group count that does not divide the heads, and B and C whose
    group counts differ, raise before any launch."""
    x = torch.zeros(1, 8, H, 16)
    a = torch.zeros(1, 8, H)
    B, C = torch.zeros(1, 8, GB, 16), torch.zeros(1, 8, GC, 16)
    with pytest.raises(ValueError, match="groups|takes a contiguous"):
        ssd_module._check(x, a, B, C, None, None, None)


@pytest.mark.parametrize("G", [1, 2, 8])
def test_check_takes_every_group_count_that_divides_the_heads(G):
    x = torch.zeros(1, 8, 8, 16)
    B = torch.zeros(1, 8, G, 16)
    ssd_module._check(x, torch.zeros(1, 8, 8), B, B, None, None, None)


def _mamba2(G):
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              param_dtype="float32", ssm_groups=G)
    gen = torch.Generator().manual_seed(G)
    return cfg, TS.init_mamba2_params(gen, cfg, torch.float32, "cpu")


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_scan_gives_the_bits_of_the_expanded_call(G):
    """``mamba2_scan`` hands B and C per group; on the CPU its output,
    conv input and state are those of the call that expanded them to the
    heads first."""
    cfg, p = _mamba2(G)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32))
    out, conv_in, state = TS.mamba2_scan(p, cfg, x)

    z, dt, want_conv = TS._mamba2_proj(p, x)
    conv_y = TS.causal_conv1d(want_conv, p["conv_w"], p["conv_b"])
    xh, x_scaled, a, Bm, Cm = TS._mamba2_heads(p, cfg, conv_y, dt, x.dtype)
    Bf, Cf = TS._expand_groups(Bm, Cm, xh.shape[2])
    y, want_state = ssd_scan_ref(x_scaled, a, Bf, Cf)
    want = TS._mamba2_output(p, cfg, y, xh, z)
    assert torch.equal(out, want) and torch.equal(conv_in, want_conv)
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_scan_never_expands_the_groups(G, monkeypatch):
    """What reaches ``ops.ssd`` on zamba2's path is B and C per group, in
    fp32: no copy per head."""
    cfg, p = _mamba2(G)
    seen = []
    real = ops.ssd

    def spy(x, a, B, C, **kw):
        seen.append((tuple(x.shape), tuple(B.shape), tuple(C.shape),
                     B.dtype, C.dtype))
        return real(x, a, B, C, **kw)

    monkeypatch.setattr(ops, "ssd", spy)
    TS.mamba2_scan(p, cfg, torch.zeros(1, 9, cfg.d_model))
    [(xs, bs, cs, bd, cd)] = seen
    H = xs[2]
    assert H > G and bs == cs == (1, 9, G, cfg.ssm_state)
    assert bd == cd == torch.float32


# --------------------------------------------------------------------------
# the path a call takes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("N,P,norm,want", [
    (64, 64, False, "chunks"),      # Mamba-2 (zamba2)
    (16, 32, False, "chunks"),
    (8, 64, False, "chunks"),
    (64, 64, True, "walk"),         # the normalizer: the ordered walk
    (128, 32, False, "walk"),
    (32, 128, False, "walk"),
    (512, 1024, True, "walk"),      # mLSTM (xlstm)
    (512, 1024, False, "walk"),
])
def test_path_by_shape_and_arguments(N, P, norm, want):
    assert ssd_module.path(N, P, norm) == want


def _c_params(src, name):
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_constants_and_entries_match_the_kernel():
    """The wrapper's threshold and argument lists are the C source's."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    assert f"constexpr int kSmallState = {ssd_module.SMALL_STATE};" in src
    assert f"constexpr int kSumBlock = {K_BLOCK};" in src
    for name, argtypes in (("ssd_scan_fwd", ssd_module._ARGTYPES),
                           ("ssd_scan_chunks_fwd",
                            ssd_module._CHUNKS_ARGTYPES)):
        params = _c_params(src, name)
        assert len(params) == len(argtypes), name
        ints = [p.startswith("int ") for p in params]
        assert ints == [t is not ssd_module.ctypes.c_void_p
                        for t in argtypes], name
        i = params.index("int H")
        assert params[i:i + 4] == ["int H", "int G", "int N", "int P"], name


# --------------------------------------------------------------------------
# the chunk-parallel path's arithmetic
# --------------------------------------------------------------------------
def _blocked(A, B):
    """A @ B over the last axis of A as the kernel sums it: products of
    K_BLOCK consecutive k summed, those sums added to the total in order."""
    out = torch.zeros(*A.shape[:-1], B.shape[-1])
    for k0 in range(0, A.shape[-1], K_BLOCK):
        out = out + A[..., k0:k0 + K_BLOCK] @ B[..., k0:k0 + K_BLOCK, :]
    return out


def _chunks_emulation(x, a, B, C, initial_state=None):
    """The chunk-parallel kernels' arithmetic in plain torch, step for
    step: chunks of CHUNK steps, the last padded with decay 1 (a = 0),
    B = C = 0 and x = 0; every decay exponent a sum of a over exactly the
    steps it spans, in order (seg[i, j] = a[j+1] + ... + a[i]).
    (a) per group and chunk CB = C . B^T in blocks; per head and chunk
        dS = B^T . (X * exp(seg[L-1, :])) in blocks, and exp(a_tot);
    (b) in order over the chunks, S_prev = S, S = exp(a_tot) S + dS;
    (c) M = CB * exp(seg) below the diagonal, 0 above;
        y = exp(a_cum) * (C . S_prev in blocks) + (M . X in blocks)."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    nc = -(-T // L)
    pad = nc * L - T

    def chunked(t):                      # [b,T,K,...] -> [b,K,nc,L,...]
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, L, t.shape[2], *t.shape[3:]).movedim(3, 1)

    X, Bc, Cc = chunked(x.float()), chunked(B.float()), chunked(C.float())
    A = chunked(a.float()[..., None])[..., 0]               # [b,H,nc,L]
    seg = torch.zeros(b, H, nc, L, L)    # seg[..., i, j], i > j, in order
    for i in range(1, L):
        seg[..., i, :i] = seg[..., i - 1, :i] + A[..., i, None]
    a_cum = A.clone()                    # a[0] + ... + a[i], in order
    for i in range(1, L):
        a_cum[..., i] = a_cum[..., i - 1] + A[..., i]
    rep = H // G
    # (a)
    CB = _blocked(Cc, Bc.transpose(-1, -2)).repeat_interleave(rep, dim=1)
    Bh = Bc.repeat_interleave(rep, dim=1)
    Ch = Cc.repeat_interleave(rep, dim=1)
    Xd = X * torch.exp(seg[..., L - 1, :])[..., None]
    dS = _blocked(Bh.transpose(-1, -2), Xd)                  # [b,H,nc,N,P]
    etot = torch.exp(a_cum[..., L - 1])                      # [b,H,nc]
    # (b)
    S = (torch.zeros(b, H, N, P) if initial_state is None
         else initial_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = etot[:, :, c, None, None] * S + dS[:, :, c]
    S_prev = torch.stack(prevs, dim=2)                       # [b,H,nc,N,P]
    # (c)
    below = torch.ones(L, L, dtype=torch.bool).tril()
    M = torch.where(below, CB * torch.exp(seg), 0.0)
    y = torch.exp(a_cum)[..., None] * _blocked(Ch, S_prev) + _blocked(M, X)
    y = y.reshape(b, H, nc * L, P)[:, :, :T].movedim(1, 2)
    return y.to(x.dtype), S


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 137, 300])
def test_chunks_emulation_vs_plain_mamba2_draws(T, init):
    """zamba2's head shape (N = P = 64, one group) at 8 heads, drawn as the
    model draws them: ragged tails, one step, exact chunks, state in and
    out."""
    b, H, G, N, P = 1, 8, 1, 64, 64
    x, a, B, C = _draw(10 + T, b, T, H, G, N, P)
    S0 = _state(11, b, H, N, P) if init else None
    got = _chunks_emulation(x, a, B, C, initial_state=S0)
    want = ssd_scan_ref(x, a, B, C, initial_state=S0)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


@pytest.mark.parametrize("G", [2, 4])
def test_chunks_emulation_vs_plain_with_groups(G):
    """More groups than one, and a state narrower than the block's 64 x 64
    (the kernels pad N and P with zeros)."""
    b, T, H, N, P = 2, 137, 4, 16, 24
    x, a, B, C = _draw(20 + G, b, T, H, G, N, P)
    S0 = _state(21, b, H, N, P)
    for g, w in zip(_chunks_emulation(x, a, B, C, initial_state=S0),
                    ssd_scan_ref(x, a, B, C, initial_state=S0)):
        _close(g, w)


def test_chunks_emulation_vs_ssd_chunked():
    """Against the JAX package's chunk-parallel form at a T it takes."""
    b, T, H, G, N, P = 1, 256, 4, 2, 32, 16
    x, a, B, C = _draw(30, b, T, H, G, N, P)
    S0 = _state(31, b, H, N, P)
    want = jax_ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, a, B, C)),
                           64, initial_state=jnp.asarray(S0.numpy()))
    for g, w in zip(_chunks_emulation(x, a, B, C, initial_state=S0), want):
        _close(g, w)

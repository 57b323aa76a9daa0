"""The scans' backwards on the CPU, against ``jax.vjp`` of the JAX package.

``ssd_scan_bwd_ref`` and ``slstm_scan_bwd_ref`` are the explicit formulas
the CUDA backwards (``csrc/ssd_scan_bwd.cu``, ``csrc/slstm_scan_bwd.cu``)
compute; the ``autograd.Function``s behind ``ssd_scan`` and ``slstm_scan``
run them on CPU tensors. Both are held here against ``jax.vjp`` of the JAX
package's own functions on the same numpy inputs: ``ssd_chunked`` (what
its mLSTM and Mamba-2 differentiate) and the sLSTM scan of
``repro/kernels/ref.py`` (``slstm_ref``), and at the model level its
``_slstm_cell``, ``_mlstm_output`` and ``_mlstm_qkvif``. The CUDA kernels
themselves are held against the same plain formulas on the card by
``chip_smoke.py``; the SSD backward's chunk formulas and the sLSTM
backward walk's order (partial dots per block summed in rank order, bf16
r's three-term split, the cell's factors, db's order) are emulated here.

Tolerances (fp32): every gradient within 2e-5 of its largest magnitude
(both sides sum in fp32 in different orders: the port step by step, JAX by
chunks; at decays of -8 a step, ~1e-4 of da's largest, which cancels
terms of e^-8 against ones of order 1), the emulation within 1e-5. The tie
cases compare exactly where the two sides' arithmetic is the same and
within 1e-6 otherwise; the old ``torch.clamp`` is off by a half of the
tied term there, orders of magnitude more.
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

from repro.kernels import ref as jax_ref
from repro.models import xlstm as jax_xlstm
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import LAUNCHES, slstm_scan, ssd_scan
from repro_torch.models import xlstm as port_xlstm

ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")
slstm_module = importlib.import_module("repro_torch.kernels.slstm_scan")
TOL = 2e-5


def _rel_max(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def saved_launches():
    saved = LAUNCHES.copy()
    yield LAUNCHES
    LAUNCHES.clear()
    LAUNCHES.update(saved)


# --------------------------------------------------------------------------
# SSD scan
# --------------------------------------------------------------------------
def _ssd_inputs(seed, b, T, H, G, N, P, decay):
    """x, a, B, C, initial state, w, and the cotangents of y, n and both
    final states, as float32 numpy. ``decay``: "mild" (-|N(0, .3)|),
    "strong" (-U(0, 8): e^-8 a step) or "near0" (-U(0, 1e-3))."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    a = {"mild": -np.abs(f(b, T, H, scale=0.3)),
         "strong": -rng.uniform(0, 8, (b, T, H)).astype(np.float32),
         "near0": -rng.uniform(0, 1e-3, (b, T, H)).astype(np.float32)}[decay]
    return dict(x=f(b, T, H, P), a=a, B=f(b, T, G, N, scale=N ** -0.5),
                C=f(b, T, G, N, scale=N ** -0.5), s0=f(b, H, N, P, scale=0.3),
                w=rng.uniform(0.1, 1, (b, T, H)).astype(np.float32),
                sn0=f(b, H, N, scale=0.3), dy=f(b, T, H, P), dn=f(b, T, H),
                dS=f(b, H, N, P), dSn=f(b, H, N))


def _jax_ssd_vjp(d, chunk, norm):
    """jax.vjp of ``ssd_chunked`` in (x, a, B, C[, w]) at d's inputs."""
    fn = lambda x, a, B, C, *w: jax_ssd_chunked(
        x, a, B, C, chunk, initial_state=jnp.asarray(d["s0"]),
        norm_weights=w[0] if norm else None,
        initial_norm_state=jnp.asarray(d["sn0"]) if norm else None)
    args = [jnp.asarray(d[k]) for k in ("x", "a", "B", "C")]
    if norm:
        args.append(jnp.asarray(d["w"]))
    _, vjp = jax.vjp(fn, *args)
    cot = ((d["dy"], d["dn"], d["dS"], d["dSn"]) if norm
           else (d["dy"], d["dS"]))
    return vjp(tuple(jnp.asarray(c) for c in cot))


SSD_CASES = [   # b, T, H, G, N, P, JAX's chunk, normalizer, decay
    (1, 64, 4, 4, 16, 8, 32, True, "mild"),     # mLSTM: G = H, normalizer
    (2, 100, 4, 1, 8, 16, 50, False, "mild"),   # Mamba-2: one group; T % 64
    (1, 37, 2, 2, 8, 8, 37, True, "mild"),      # T < 64, ragged
    (1, 130, 4, 2, 16, 8, 65, False, "strong"),
    (1, 130, 2, 1, 8, 8, 65, True, "near0"),
]


@pytest.mark.parametrize("b,T,H,G,N,P,chunk,norm,decay", SSD_CASES)
def test_ssd_bwd_ref_vs_jax_vjp(b, T, H, G, N, P, chunk, norm, decay):
    """dx, da, dB, dC (and dw) of ``ssd_scan_bwd_ref`` against jax.vjp of
    ``ssd_chunked``, from an initial state, with every result's cotangent
    (the final states' too); dB and dC summed over each group's heads.
    da within 1e-4 under strong decay (see the module doc)."""
    d = _ssd_inputs(T + N, b, T, H, G, N, P, decay)
    want = _jax_ssd_vjp(d, chunk, norm)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = ssd_module.ssd_scan_bwd_ref(
        t["x"], t["a"], t["B"], t["C"], t["dy"], initial_state=t["s0"],
        norm_weights=t["w"] if norm else None,
        initial_norm_state=t["sn0"] if norm else None,
        dn=t["dn"] if norm else None, d_state=t["dS"],
        d_norm_state=t["dSn"] if norm else None)
    assert (got[4] is None) == (not norm)
    for name, g, w in zip(("dx", "da", "dB", "dC", "dw"), got, want):
        tol = 1e-4 if (name == "da" and decay == "strong") else TOL
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_max(g, w) <= tol, (name, _rel_max(g, w))


@pytest.mark.parametrize("norm", [True, False])
def test_ssd_function_cpu_vs_jax_vjp(norm, saved_launches):
    """``ssd_scan`` with inputs that require grad goes through ``SsdScan``
    (the plain forward and ``ssd_scan_bwd_ref`` on CPU tensors, no
    launch); its gradients equal jax.vjp's when only y (and n) feed the
    loss, as in both models."""
    b, T, H, G, N, P, chunk = 2, 96, 4, 2, 16, 8, 48
    d = _ssd_inputs(3, b, T, H, G, N, P, "mild")
    d["dS"], d["dSn"] = np.zeros_like(d["dS"]), np.zeros_like(d["dSn"])
    d["s0"], d["sn0"] = np.zeros_like(d["s0"]), np.zeros_like(d["sn0"])
    want = _jax_ssd_vjp(d, chunk, norm)
    names = ["x", "a", "B", "C"] + (["w"] if norm else [])
    t = {k: torch.from_numpy(d[k]).requires_grad_() for k in names}
    saved_launches.clear()
    out = ssd_scan(t["x"], t["a"], t["B"], t["C"],
                   norm_weights=t["w"] if norm else None)
    assert out[0].grad_fn is not None
    assert type(out[0].grad_fn).__name__ == "SsdScanBackward"
    loss = (out[0] * torch.from_numpy(d["dy"])).sum()
    if norm:
        loss = loss + (out[1] * torch.from_numpy(d["dn"])).sum()
    got = torch.autograd.grad(loss, [t[k] for k in names])
    assert sum(saved_launches.values()) == 0
    for name, g, w in zip(names, got, want):
        assert _rel_max(g, w) <= TOL, (name, _rel_max(g, w))


def test_ssd_initial_state_requiring_grad_raises():
    x = torch.zeros(1, 4, 2, 8, requires_grad=True)
    a, B = torch.zeros(1, 4, 2), torch.zeros(1, 4, 2, 8)
    s0 = torch.zeros(1, 2, 8, 8, requires_grad=True)
    with pytest.raises(ValueError, match="initial_state requires grad"):
        ssd_scan(x, a, B, B, initial_state=s0)


def _ssd_bwd_chunked_emulation(x, a, B, C, dy, s0=None, dsf=None, L=64):
    """``csrc/ssd_scan_bwd.cu``'s chunk formulas in plain torch (the
    normalizer as x's extra column): per chunk of L steps, Dm, ea, eb and
    etot from in-chunk cumulative sums, dS and dG, the ordered pass for
    S_prev and Gin, then dx, dB, dC (per head, then summed per group) and
    da's four terms. Returns (dx, da, dB, dC)."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    rep, nc = H // G, -(-T // L)

    def pad(t):                     # zeros past T: decay 1, no input
        return torch.cat([t, t.new_zeros((b, nc * L - T) + t.shape[2:])], 1)

    x, a, dy = (pad(t).reshape(b, nc, L, *t.shape[2:]) for t in (x, a, dy))
    Bh, Ch = (pad(t.repeat_interleave(rep, 2)).reshape(b, nc, L, H, N)
              for t in (B, C))
    A = torch.cumsum(a, 2)                                      # A_u
    lower = torch.tril(torch.ones(L, L, dtype=torch.bool))[None, None, :, :, None]
    Dm = torch.exp(torch.where(lower, A[:, :, :, None] - A[:, :, None],
                               -torch.inf))                    # [b,c,u,r,H]
    ea, eb, etot = torch.exp(A), torch.exp(A[:, :, -1:] - A), torch.exp(A[:, :, -1])
    dS = torch.einsum("bcrhn,bcrh,bcrhp->bchnp", Bh, eb, x)
    dG = torch.einsum("bcuhn,bcuh,bcuhp->bchnp", Ch, ea, dy)
    S = torch.zeros(b, H, N, P) if s0 is None else s0
    Gin = torch.zeros(b, H, N, P) if dsf is None else dsf
    Sp, Gi = [], [None] * nc
    for c in range(nc):
        Sp.append(S)
        S = etot[:, c, :, None, None] * S + dS[:, c]
    for c in reversed(range(nc)):
        Gi[c] = Gin
        Gin = dG[:, c] + etot[:, c, :, None, None] * Gin
    Sp, Gi = torch.stack(Sp, 1), torch.stack(Gi, 1)
    CB = torch.einsum("bcuhn,bcrhn->bcurh", Ch, Bh)
    XD = torch.einsum("bcuhp,bcrhp->bcurh", dy, x)
    dx = (eb[..., None] * torch.einsum("bcshn,bchnp->bcshp", Bh, Gi)
          + torch.einsum("bcush,bcuhp->bcshp", Dm * CB, dy))
    dBh = (eb[..., None] * torch.einsum("bchnp,bcshp->bcshn", Gi, x)
           + torch.einsum("bcush,bcuhn->bcshn", Dm * XD, Ch))
    dCh = (ea[..., None] * torch.einsum("bchnp,bcuhp->bcuhn", Sp, dy)
           + torch.einsum("bcurh,bcrhn->bcuhn", Dm * XD, Bh))
    q = torch.einsum("bcuhn,bchnp,bcuhp->bcuh", Ch, Sp, dy)
    k = torch.einsum("bcrhn,bchnp,bcrhp->bcrh", Bh, Gi, x)
    W = Dm * CB * XD
    da = torch.stack([etot * (Sp * Gi).sum((-1, -2))
                      + (ea[:, :, s:] * q[:, :, s:]).sum(2)
                      + (eb[:, :, :s] * k[:, :, :s]).sum(2)
                      + W[:, :, s:, :s].sum((2, 3)) for s in range(L)], 2)

    def unchunk(t):
        return t.reshape(b, nc * L, *t.shape[3:])[:, :T]

    dB = unchunk(dBh).reshape(b, T, G, rep, N).sum(3)
    dC = unchunk(dCh).reshape(b, T, G, rep, N).sum(3)
    return unchunk(dx), unchunk(da), dB, dC


@pytest.mark.parametrize("b,T,H,G,N,P,chunk,norm,decay", SSD_CASES)
def test_ssd_bwd_kernel_formulas_vs_plain(b, T, H, G, N, P, chunk, norm,
                                          decay):
    """The CUDA backward's chunk formulas (emulated) against
    ``ssd_scan_bwd_ref``: the normalizer as x's extra column (w appended to
    x, dn to dy) gives dw as dx's last column, the state's gradient as the
    pass's start, da's four terms; every exponent is <= 0, so strong
    decays stay finite."""
    d = _ssd_inputs(T + N, b, T, H, G, N, P, decay)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    want = ssd_module.ssd_scan_bwd_ref(
        t["x"], t["a"], t["B"], t["C"], t["dy"], initial_state=t["s0"],
        norm_weights=t["w"] if norm else None,
        initial_norm_state=t["sn0"] if norm else None,
        dn=t["dn"] if norm else None, d_state=t["dS"],
        d_norm_state=t["dSn"] if norm else None)
    col = lambda m, e: torch.cat([m, e[..., None]], -1) if norm else m
    got = _ssd_bwd_chunked_emulation(
        col(t["x"], t["w"]), t["a"], t["B"], t["C"], col(t["dy"], t["dn"]),
        col(t["s0"], t["sn0"]), col(t["dS"], t["dSn"]))
    assert all(torch.isfinite(g).all() for g in got)
    pairs = [(got[0][..., :P], want[0]), *zip(got[1:], want[1:4])]
    if norm:
        pairs.append((got[0][..., P], want[4]))
    for g, w in pairs:
        assert _rel_max(g, w.numpy()) <= 1e-5


# --------------------------------------------------------------------------
# sLSTM scan
# --------------------------------------------------------------------------
def _slstm_inputs(seed, B, T, nh, dh, i_scale=1.0):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((B, T, nh, 4 * dh)).astype(np.float32)
    wx[..., :dh] *= i_scale                    # the input gate's pre-activation
    r = (rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    b = rng.standard_normal((nh, 4 * dh)).astype(np.float32) * 0.5
    dhs = rng.standard_normal((B, T, nh, dh)).astype(np.float32)
    return wx, r, b, dhs


def _jax_slstm_vjp(wx, r, b, dhs, r_dtype=jnp.float32):
    _, vjp = jax.vjp(jax_ref.slstm_ref, jnp.asarray(wx),
                     jnp.asarray(r).astype(r_dtype), jnp.asarray(b))
    return vjp(jnp.asarray(dhs))


@pytest.mark.parametrize("B,T,nh,dh,i_scale", [
    (2, 9, 2, 16, 1.0),
    (1, 70, 4, 8, 1.0),
    (3, 20, 1, 32, 20.0),     # i past I_CLAMP: the minimum's zero side
])
def test_slstm_bwd_ref_vs_jax_vjp(B, T, nh, dh, i_scale):
    """dwx, dr, db of ``slstm_scan_bwd_ref`` against jax.vjp of the JAX
    package's sLSTM scan (``repro/kernels/ref.py`` ``slstm_ref``): the
    minimum at I_CLAMP, log_sigmoid, both branches of the max that gives
    m_t, and maximum(n_t, 1) with its tie at every unit's first step; no
    NaN at t = 0, where m starts at -1e30."""
    wx, r, b, dhs = _slstm_inputs(B * T + dh, B, T, nh, dh, i_scale)
    want = _jax_slstm_vjp(wx, r, b, dhs)
    got = slstm_module.slstm_scan_bwd_ref(*map(torch.from_numpy,
                                               (wx, r, b, dhs)))
    for name, g, w in zip(("dwx", "dr", "db"), got, want):
        assert torch.isfinite(g).all()
        assert _rel_max(g, w) <= TOL, (name, _rel_max(g, w))


@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_slstm_function_cpu_vs_jax_vjp(r_dtype, saved_launches):
    """``slstm_scan`` with inputs that require grad goes through
    ``SlstmScan`` (plain forward and backward on CPU tensors, no launch),
    with r in either dtype the forward takes; dr in r's dtype, JAX's fp32
    sum rounded to it."""
    B, T, nh, dh = 2, 24, 2, 16
    wx, r, b, dhs = _slstm_inputs(5, B, T, nh, dh)
    r = np.asarray(jnp.asarray(r).astype(getattr(jnp, r_dtype))
                   .astype(jnp.float32))
    want = list(_jax_slstm_vjp(wx, r, b, dhs))
    # JAX's own bf16 dr rounds each step's cotangent to bf16 and sums them
    # in bf16; the port sums in fp32 and rounds once: held to JAX's fp32 sum
    # (r's values in fp32) within that one rounding
    want[1] = np.array(want[1], np.float32)
    twx, tb = (torch.from_numpy(v).requires_grad_() for v in (wx, b))
    tr = torch.from_numpy(r).to(getattr(torch, r_dtype)).requires_grad_()
    saved_launches.clear()
    hs, state = slstm_scan(twx, tr, tb)
    assert type(hs.grad_fn).__name__ == "SlstmScanBackward"
    got = torch.autograd.grad((hs * torch.from_numpy(dhs)).sum(),
                              (twx, tr, tb))
    assert sum(saved_launches.values()) == 0
    assert got[1].dtype == tr.dtype
    for name, g, w in zip(("dwx", "dr", "db"), got, want):
        if name == "dr" and r_dtype == "bfloat16":   # one rounding to bf16
            err = np.abs(g.float().numpy() - w)
            assert (err <= 2 ** -8 * np.abs(w) + TOL * np.abs(w).max()).all()
        else:
            assert _rel_max(g, np.asarray(w, np.float32)) <= TOL, name


@pytest.mark.parametrize("wx_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_slstm_bwd_plan_fits_or_raises(r_dtype, wx_dtype):
    """For every shape the forward's ``slstm_plan`` takes (B 1-16, dh 16-512
    and some it refuses), ``slstm_bwd_plan`` gives the forward's cluster
    (G blocks of 16 or 32 units), a tile of 1, 2 or TILE batch rows and a
    layout within SMEM_MAX; bf16 r holds R in registers (no resident rows),
    fp32 r keeps whole warps' rows resident (or all of them) and reads the
    rest from L2. A shape the forward refuses, the backward refuses with a
    reason."""
    r_dt, wx_dt = getattr(torch, r_dtype), getattr(torch, wx_dtype)
    taken = 0
    for B in list(range(1, 17)) + [0, 17]:
        for dh in list(range(16, 513, 16)) + [8, 40, 1024]:
            try:
                fwd = slstm_module.slstm_plan(B, 4, dh, r_dt)
            except ValueError as refused:
                with pytest.raises(ValueError, match=str(refused)[:20]):
                    slstm_module.slstm_bwd_plan(B, 4, dh, r_dt, wx_dt)
                continue
            plan = slstm_module.slstm_bwd_plan(B, 4, dh, r_dt, wx_dt)
            taken += 1
            assert (plan.blocks, plan.units) == (fwd.blocks, fwd.units)
            assert plan.tile == (B if B <= 2 else slstm_module.TILE)
            assert (plan.smem_bytes + slstm_module.BARRIER_BYTES
                    <= slstm_module.SMEM_MAX), (B, dh)
            if r_dt == torch.bfloat16:
                assert plan.resident_rows == 0
            else:
                assert 0 <= plan.resident_rows <= dh
                assert (plan.resident_rows == dh or plan.resident_rows
                        % slstm_module.BWD_WARP_ROWS == 0)
    assert taken == 16 * 24     # dh 272-496 with 16-unit blocks: 17-31 > 16
    with pytest.raises(ValueError, match="wx must be"):
        slstm_module.slstm_bwd_plan(4, 4, 64, r_dt, torch.float16)
    full = slstm_module.slstm_bwd_plan(4, 4, 512, torch.float32, wx_dt)
    assert full.resident_rows < 512      # a 256 KiB fp32 slice does not fit


def _split3(x):
    """bf16 r's operand: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
    - mid), each as fp32 (the kernel's ``split3``)."""
    hi = x.to(torch.bfloat16).float()
    r1 = x - hi
    mid = r1.to(torch.bfloat16).float()
    return hi, mid, (r1 - mid).to(torch.bfloat16).float()


def _slstm_bwd_kernel_order(wx, r, b, dhs, units, r_bf16):
    """``csrc/slstm_scan_bwd.cu``'s walk in plain torch, in its order: the
    cell from the forward step's factors (``forward_step``: c_t / n', o /
    n', ...), dh_t = dhs_t + the G blocks' partial dots summed in rank order
    (block k's columns: gate q of units [k units, (k + 1) units)); with bf16
    r each partial is R times dpre's three bf16 terms, summed (hi + mid) +
    lo; db summed over time per (batch row, unit), then over batch rows in
    order. Returns (dwx, dr, db) fp32; dr as the wrapper's product."""
    B, T, nh, gd = wx.shape
    dh = gd // 4
    rf, bf = r.float(), b.float()
    zeros = torch.zeros(B, nh, dh)
    states = [(zeros, zeros, torch.full_like(zeros, slstm_module.M_INIT),
               zeros)]
    pres = []
    for t in range(T):
        pres.append(wx[:, t].float() + torch.einsum(
            "bhd,hde->bhe", states[-1][3], rf) + bf[None])
        states.append(slstm_module._cell(pres[-1], *states[-1][:3]))
    tie = slstm_module._tie
    blocks = [torch.cat([torch.arange(q * dh + k * units,
                                      q * dh + (k + 1) * units)
                         for q in range(4)]) for k in range(dh // units)]
    dc, dn, dm, rec = zeros, zeros, zeros, zeros
    dwx = torch.empty(B, T, nh, gd)
    dbq = torch.zeros(B, nh, gd)
    for t in reversed(range(T)):
        c, n, m = states[t][:3]
        i_r, f_r, z_r, o_r = pres[t].chunk(4, dim=-1)
        i_log = torch.minimum(i_r, torch.full_like(i_r, slstm_module.I_CLAMP))
        a = F.logsigmoid(f_r) + m
        m_new = torch.maximum(a, i_log)
        ig, fg = torch.exp(i_log - m_new), torch.exp(a - m_new)
        z, o = torch.tanh(z_r), 1 / (1 + torch.exp(-o_r))
        c_new, n_new = fg * c + ig * z, fg * n + ig
        nn = torch.maximum(n_new, torch.ones_like(n_new))
        a_do, a_dc = c_new / nn, o / nn
        a_dn = o * c_new / (nn * nn) * tie(n_new, 1.0)
        share = tie(a, i_log)
        gh = dhs[:, t].float() + rec
        dc_t, dn_t = dc + gh * a_dc, dn - gh * a_dn
        dfg, dig = dc_t * c + dn_t * n, dc_t * z + dn_t
        t_ig, t_fg = dig * ig, dfg * fg
        dm_t = dm - t_ig - t_fg
        da = t_fg + dm_t * share
        dp = torch.cat([(t_ig + dm_t * (1 - share))
                        * tie(-i_r, torch.tensor(-slstm_module.I_CLAMP)),
                        da * (1 / (1 + torch.exp(f_r))),
                        dc_t * (ig * (1 - z * z)), gh * a_do * (o * (1 - o))],
                       dim=-1)
        dc, dn, dm = dc_t * fg, dn_t * fg, da
        dwx[:, t] = dp
        dbq += dp
        rec = zeros
        for cols in blocks:                  # rank order
            rk = rf[:, :, cols]
            if r_bf16:
                hi, mid, lo = (torch.einsum("bhe,hde->bhd", x, rk)
                               for x in _split3(dp[..., cols]))
                part = (hi + mid) + lo
            else:
                part = torch.einsum("bhe,hde->bhd", dp[..., cols], rk)
            rec = rec + part
    db = dbq[0].clone()
    for row in dbq[1:]:
        db += row
    h_prev = torch.stack([s[3] for s in states[:-1]], 1)   # h_{t-1}, h_{-1} = 0
    dr = torch.einsum("btnd,btne->nde", h_prev, dwx)
    return dwx, dr, db


@pytest.mark.parametrize("B,T,nh,dh,i_scale,r_dtype", [
    (2, 9, 2, 32, 1.0, "float32"),
    (3, 20, 1, 48, 20.0, "bfloat16"),   # 16-unit blocks; i past I_CLAMP
    (2, 12, 2, 64, 20.0, "bfloat16"),   # two 32-unit blocks
    (1, 1, 2, 32, 1.0, "bfloat16"),     # T = 1: no recurrent product
])
def test_slstm_bwd_kernel_order_vs_jax_vjp(B, T, nh, dh, i_scale, r_dtype):
    """The CUDA walk's order (emulated) against jax.vjp of ``slstm_ref``:
    dwx, db and the wrapper's dr within TOL of their largest magnitudes,
    with r in either dtype (bf16 r: its fp32 values on both sides) and the
    input gate past I_CLAMP where i_scale is 20."""
    wx, r, b, dhs = _slstm_inputs(B * T + dh + 1, B, T, nh, dh, i_scale)
    rt = torch.from_numpy(r).to(getattr(torch, r_dtype))
    want = _jax_slstm_vjp(wx, rt.float().numpy(), b, dhs)
    units = slstm_module.slstm_plan(B, nh, dh, rt.dtype).units
    got = _slstm_bwd_kernel_order(torch.from_numpy(wx), rt,
                                  torch.from_numpy(b), torch.from_numpy(dhs),
                                  units, rt.dtype == torch.bfloat16)
    if i_scale > 1:
        assert (np.abs(wx[..., :dh]) > slstm_module.I_CLAMP).any()
    for name, g, w in zip(("dwx", "dr", "db"), got, want):
        assert torch.isfinite(g).all()
        assert _rel_max(g, w) <= TOL, (name, _rel_max(g, w))


# --------------------------------------------------------------------------
# the tie fault: torch.clamp against jnp.maximum / jnp.minimum
# --------------------------------------------------------------------------
def _old_slstm_cell(p, cfg, wx_t, state):
    """The port's sLSTM cell before the repair: torch.clamp where JAX has
    jnp.minimum / jnp.maximum (at a tie clamp sends all of the gradient to
    its input, JAX half)."""
    d, nh = cfg.d_model, cfg.n_heads
    c, n, m, h = state
    rec = torch.einsum("bhd,hde->bhe", h.reshape(-1, nh, d // nh).float(),
                       p["r"].float())
    rec = rec.reshape(-1, nh, 4, d // nh).transpose(1, 2).reshape(-1, 4 * d)
    i_r, f_r, z_r, o_r = (wx_t.float() + rec + p["b"]).split(d, dim=-1)
    i_log = torch.clamp(i_r, max=port_xlstm.I_CLAMP)
    f_log = F.logsigmoid(f_r)
    m_new = torch.maximum(f_log + m, i_log)
    ig, fg = torch.exp(i_log - m_new), torch.exp(f_log + m - m_new)
    c_new = fg * c + ig * torch.tanh(z_r)
    n_new = fg * n + ig
    return torch.sigmoid(o_r) * c_new / torch.clamp(n_new, min=1.0)


def _xlstm_configs():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import ArchConfig
    jcfg = dataclasses.replace(jax_get_config("xlstm-1.3b").reduced(),
                               param_dtype="float32")
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _slstm_cell_case():
    """One sLSTM step (``_slstm_cell``) from a state with n = 1 and m = 0,
    the forget gate open (f = 30: the max gives m_t = log_sigmoid(f) + m,
    so fg = exp(0) = 1) and the input gate shut (i = -200: ig underflows to
    0), so n_t = 1 exactly and maximum(n_t, 1) ties; the gradient with
    respect to the state n before the step. (At t = 0, where n_t = 1 too,
    the tie changes no gradient: there m_t = i and fg = 0, and dn's share
    cancels between ig and m_t.)"""
    jcfg, cfg = _xlstm_configs()
    rng = np.random.default_rng(7)
    d, nh = cfg.d_model, cfg.n_heads
    p = {"r": np.zeros((nh, d // nh, 4 * d // nh), np.float32),
         "b": np.zeros(4 * d, np.float32)}
    wx = rng.standard_normal((3, 4 * d)).astype(np.float32)
    wx[:, :d], wx[:, d:2 * d] = -200.0, 30.0
    c = rng.standard_normal((3, d)).astype(np.float32)
    n, m, h = (np.ones((3, d), np.float32), np.zeros((3, d), np.float32),
               np.zeros((3, d), np.float32))
    dh = rng.standard_normal((3, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda nn: jax_xlstm._slstm_cell(
        jax.tree_util.tree_map(jnp.asarray, p), jcfg, jnp.asarray(wx),
        (jnp.asarray(c), nn, jnp.asarray(m), jnp.asarray(h)))[3],
        jnp.asarray(n))
    want = np.asarray(vjp(jnp.asarray(dh))[0])
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    def grad(cell):
        tn = torch.from_numpy(n).requires_grad_()
        out = cell(tp, cfg, torch.from_numpy(wx),
                   (torch.from_numpy(c), tn, torch.from_numpy(m),
                    torch.from_numpy(h)))
        out = out[3] if isinstance(out, tuple) else out
        return torch.autograd.grad(out, tn, torch.from_numpy(dh))[0]
    return grad(port_xlstm._slstm_cell), grad(_old_slstm_cell), want


def _gates_case():
    """``_gates`` with the input gate's pre-activation exactly at I_CLAMP
    at a quarter of the entries: minimum(i, I_CLAMP)'s tie."""
    rng = np.random.default_rng(9)
    nh = 4
    gif = rng.standard_normal((2, 8, 2, nh)).astype(np.float32)
    p = {"b_i": np.full(nh, -2.0, np.float32),
         "b_f": np.full(nh, 3.0, np.float32)}
    tied = np.arange(2 * 8 * nh).reshape(2, 8, nh) % 4 == 0
    gif[..., 0, :][tied] = port_xlstm.I_CLAMP + 2.0     # + b_i: I_CLAMP exactly
    gi = rng.standard_normal((2, 8, nh)).astype(np.float32)

    def jax_gates(g):
        i_log = jnp.minimum(g[..., 0, :] + p["b_i"], port_xlstm.I_CLAMP)
        return i_log                # as repro/models/xlstm.py:83
    _, vjp = jax.vjp(jax_gates, jnp.asarray(gif))
    want = np.asarray(vjp(jnp.asarray(gi))[0])

    def grad(low):
        tg = torch.from_numpy(gif).requires_grad_()
        saved = port_xlstm.scalar_min
        port_xlstm.scalar_min = low
        try:
            i_log, _ = port_xlstm._gates(
                {k: torch.from_numpy(v) for k, v in p.items()}, tg)
        finally:
            port_xlstm.scalar_min = saved
        return torch.autograd.grad(i_log, tg, torch.from_numpy(gi))[0]
    return (grad(port_xlstm.scalar_min),
            grad(lambda x, v: torch.clamp(x, max=v)), want)


@pytest.mark.parametrize("case", [_slstm_cell_case, _gates_case])
def test_tie_fault_repaired(case):
    """At a tie of jnp.maximum / jnp.minimum JAX gives each side half the
    gradient. The repaired port (``scalar_max`` / ``scalar_min``, i.e.
    torch.maximum / torch.minimum) matches JAX's gradient; the old
    ``torch.clamp`` does not (it is off by half the tied term). The third
    repaired site, ``_mlstm_output``'s maximum(|n|, 1), is not among them:
    the group norm after it makes the block's output invariant to that
    per-head scale up to its eps, so its gradient in n is rounding noise
    at a tie as anywhere else."""
    fixed, old, want = case()
    assert _rel_max(fixed, want) <= 1e-6
    assert _rel_max(old, want) > 1e-2


def test_slstm_cell_bwd_splits_ties_as_jax():
    """``cell_bwd`` (the kernel's local backward) against jax.vjp of the
    same step of ``slstm_ref``'s cell, every input's gradient: rows 0-1 at
    t = 0 (m = -1e30, n_t = 1) with i exactly at I_CLAMP in half the
    units (the minimum's tie), rows 2-3 at n_t = 1 with fg = 1 (n = 1, m =
    0, f = 30, i = -200: the maximum's tie that reaches dn)."""
    rng = np.random.default_rng(11)
    B, dh = 4, 8
    pre = rng.standard_normal((B, 4 * dh)).astype(np.float32)
    pre[:2, : dh // 2] = port_xlstm.I_CLAMP
    pre[2:, :dh], pre[2:, dh:2 * dh] = -200.0, 30.0
    c = rng.standard_normal((B, dh)).astype(np.float32)
    c[:2] = 0.0
    n = np.ones((B, dh), np.float32)
    n[:2] = 0.0
    m = np.zeros((B, dh), np.float32)
    m[:2] = -1e30
    g = [rng.standard_normal((B, dh)).astype(np.float32) for _ in range(4)]

    def jax_cell(pre, c, n, m):
        i_r, f_r, z_r, o_r = jnp.split(pre, 4, axis=-1)
        i_log = jnp.minimum(i_r, 15.0)
        f_log = jax.nn.log_sigmoid(f_r)
        m_new = jnp.maximum(f_log + m, i_log)
        ig, fg = jnp.exp(i_log - m_new), jnp.exp(f_log + m - m_new)
        c_new = fg * c + ig * jnp.tanh(z_r)
        n_new = fg * n + ig
        h = jax.nn.sigmoid(o_r) * c_new / jnp.maximum(n_new, 1.0)
        return h, c_new, n_new, m_new
    _, vjp = jax.vjp(jax_cell, *map(jnp.asarray, (pre, c, n, m)))
    want = vjp(tuple(map(jnp.asarray, g)))
    t = torch.from_numpy
    got = slstm_module.cell_bwd(t(pre), t(c), t(n), t(m), *map(t, g))
    for name, x, w in zip(("dpre", "dc", "dn", "dm"), got, want):
        assert torch.isfinite(x).all()
        assert _rel_max(x, w) <= 1e-6, name


# --------------------------------------------------------------------------
# the CUDA sources and their wrappers (checked without a card)
# --------------------------------------------------------------------------
def _c_params(src, name):
    head = f'extern "C" int {name}('
    sig = src[src.index(head) + len(head):]
    return [p.strip() for p in sig[:sig.index(")")].split(",")]


def _code(name):
    """A CUDA source without its comments."""
    from repro_torch.kernels import build
    return "\n".join(line.split("//")[0] for line in
                     (build.CSRC / name).read_text().splitlines())


@pytest.mark.parametrize("source,entry,argtypes", [
    ("ssd_scan_bwd.cu", "ssd_scan_bwd", ssd_module._BWD_ARGTYPES),
    ("ssd_scan_bwd.cu", "ssd_scan_bwd_workspace",
     ssd_module._BWD_WS_ARGTYPES),
    ("ssd_scan_bwd.cu", "ssd_scan_bwd_occupancy",
     ssd_module._BWD_OCC_ARGTYPES),
    ("slstm_scan_bwd.cu", "slstm_scan_bwd", slstm_module._BWD_ARGTYPES),
    ("slstm_scan_bwd.cu", "slstm_bwd_max_clusters",
     slstm_module._BWD_OCC_ARGTYPES),
    ("slstm_scan.cu", "slstm_scan_fwd", slstm_module._ARGTYPES),
])
def test_backward_c_entries_take_what_the_wrappers_pass(source, entry,
                                                        argtypes):
    """Each C entry takes as many arguments as its wrapper declares, ints
    where the wrapper passes ``c_int`` (ctypes would not notice a
    mismatch); the backward sources are in the build, use no atomics (one
    owner per output: two calls give the same bits) and share the
    wrappers' constants."""
    from repro_torch.kernels import build
    assert source in {p.name for p in build.sources()}
    params = _c_params(_code(source), entry)
    assert len(params) == len(argtypes)
    assert [p.startswith("int ") for p in params] == [
        t is slstm_module.ctypes.c_int for t in argtypes]
    code = _code(source)
    assert "atomic" not in code
    if source == "ssd_scan_bwd.cu":
        assert f"constexpr int kL = {ssd_module.CHUNK};" in code
    if source == "slstm_scan_bwd.cu":       # the layout slstm_bwd_plan mirrors
        for name, value in (("kThreads", slstm_module.THREADS),
                            ("kTile", slstm_module.TILE),
                            ("kMaxBatch", slstm_module.MAX_BATCH),
                            ("kMaxCluster", slstm_module.MAX_CLUSTER),
                            ("kMaxSmem", slstm_module.SMEM_MAX),
                            ("kBarrierBytes", slstm_module.BARRIER_BYTES),
                            ("kStages", slstm_module.BWD_STAGES),
                            ("kWarpRows", slstm_module.BWD_WARP_ROWS)):
            assert f"constexpr int {name} = {value};" in code
        assert "constexpr int kScratchRow = kWarpRows + 4;" in code


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


def test_backward_wrappers_raise_on_other_devices():
    x = _Elsewhere(1, 8, 2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_module.ssd_scan_bwd(x, _Elsewhere(1, 8, 2), x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        slstm_module.slstm_scan_bwd(_Elsewhere(1, 8, 2, 64),
                                    _Elsewhere(2, 16, 64), _Elsewhere(2, 64),
                                    _Elsewhere(1, 8, 2, 16))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ssd_bwd_kernel_names_are_the_ones_chip_smoke_traces():
    """``chip_smoke.py`` splits ``ssd_scan_bwd``'s time by kernel name
    (``SSD_BWD_KERNELS``; the products' flops and the pass's bytes in
    ``kernels.work.ssd_bwd_products``), logs the products' occupancy by name and counts the
    Trainer's ``ssd_scan_bwd`` calls by ``ssd_bwd_da_kernel`` in its trace:
    each name it looks for is a kernel that ``ssd_scan_bwd.cu`` launches."""
    smoke = _chip_smoke()
    code = _code("ssd_scan_bwd.cu")
    launched = set(re.findall(r"\b(ssd_bwd_\w+_kernel)(?:<[^<>]*>)?<<<", code))
    assert launched == set(smoke.SSD_BWD_KERNELS)
    assert set(smoke.work.ssd_bwd_products(1, 64, 1, 1, 8, 4)) <= launched
    assert {f"ssd_bwd_{name}_kernel"
            for name in ssd_module.BWD_PRODUCTS} <= launched
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert '"ssd_bwd_da_kernel": want["ssd_scan_bwd"]' in text


def test_slstm_bwd_is_one_launch_of_the_kernel_chip_smoke_traces():
    """``csrc/slstm_scan_bwd.cu`` defines one kernel, the walk, launched
    once a call through cudaLaunchKernelEx (no step kernel, no db kernel,
    no launch loop); phase 5i counts the Trainer's ``slstm_scan_bwd`` calls
    by that name, which its "scan bwd" group matches by "slstm_bwd"."""
    code = _code("slstm_scan_bwd.cu")
    kernels = set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\(", code))
    assert kernels == {"slstm_bwd_walk_kernel"}
    assert code.count("cudaLaunchKernelEx(") == 1 and "<<<" not in code
    for gone in ("slstm_bwd_step_kernel", "slstm_bwd_bias_kernel", "walk<"):
        assert gone not in code
    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert 'expect["slstm_bwd_walk_kernel"] = want["slstm_scan_bwd"]' in text
    assert '"slstm_bwd" in name' in text


def test_ssd_bwd_padded_layout():
    """x and dy reach the backward kernels with the normalizer's column at P
    and zero columns up to ``bwd_width`` (a multiple of 4: 16-byte rows),
    contiguous and 16-byte aligned (a misaligned view is copied); the
    states keep Pe columns; dx and dw come back as the kernels' first P
    columns and column P, without a copy."""
    assert [ssd_module.bwd_width(pe) for pe in (1025, 1024, 64, 6, 9)] == [
        1028, 1024, 64, 8, 12]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((2, 5, 3)).astype(np.float32))
    xe = ssd_module.bwd_columns(x, w, ssd_module.bwd_width(9))
    assert xe.shape == (2, 5, 3, 12) and xe.is_contiguous()
    assert xe.data_ptr() % 16 == 0
    assert torch.equal(xe[..., :8], x) and torch.equal(xe[..., 8], w)
    assert not xe[..., 9:].any()
    state = ssd_module.bwd_columns(x, w, 9)           # the states: Pe columns
    assert state.shape == (2, 5, 3, 9) and torch.equal(state[..., 8], w)
    assert ssd_module.bwd_columns(x, None, 8) is x    # nothing to add
    flat = torch.zeros(x.numel() + 1)
    view = flat[1:].view(x.shape)                     # 4 bytes off a boundary
    view.copy_(x)
    moved = ssd_module.bwd_columns(view, None, 8)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)
    dx, dw = ssd_module.bwd_split(xe, 8, True)
    assert torch.equal(dx, x) and torch.equal(dw, w)
    assert dx.data_ptr() == xe.data_ptr()             # views of the kernels' dx
    dx, dw = ssd_module.bwd_split(xe, 12, False)
    assert dx is xe and dw is None
    dx, dw = ssd_module.bwd_split(ssd_module.bwd_columns(x, None, 12), 8,
                                  False)
    assert torch.equal(dx, x) and dw is None

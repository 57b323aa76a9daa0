"""sLSTM time scan for Hopper: the CUDA kernel's wrapper, its launch plan and
its plain version.

``slstm_scan`` launches ``csrc/slstm_scan.cu`` on a CUDA tensor and runs
``slstm_scan_ref`` on a CPU tensor; nothing else. The kernel replaces the
Pallas TPU kernel ``repro/kernels/slstm_scan.py`` and also returns the final
(c, n, m, h) state, which prefill hands to decode: one thread-block cluster
per head, h exchanged through distributed shared memory (see the note at
the top of the CUDA source for what bounds it and how). ``slstm_plan``
chooses the cluster shape and the shared-memory layout.

Where grad is enabled and wx, r or b requires it, the call goes through an
``autograd.Function``: the forward then also writes each step's gate
pre-activations and (c, n, m, h), and the backward (``slstm_scan_bwd``)
walks time in reverse, on the card through ``csrc/slstm_scan_bwd.cu`` (one
launch of a cluster per head, laid out by ``slstm_bwd_plan``), on CPU
tensors through the explicit formulas of ``slstm_scan_bwd_ref``. Both
follow JAX's derivative, ties included: ``jnp.maximum`` / ``jnp.minimum``
give each side half the gradient at a tie (``scalar_max``, ``scalar_min``).

On the ``meta`` device (the dry-run's abstract evaluation) a call checks
and plans as the card's path does (``slstm_plan`` and ``slstm_bwd_plan``
raise for a shape the kernels cannot take: B past ``MAX_BATCH``, for
one), returns empty outputs (the forward's trace too), allocates what the
card's path allocates, adds its work to ``work.FLOPS``
and launches nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build, work

F32 = torch.float32
I_CLAMP = 15.0
M_INIT = -1e30                  # the TPU kernel's initial m
MAX_BATCH = 16                  # kMaxBatch in csrc/slstm_scan.cu
THREADS = 256                   # kThreads: threads per block
TILE = 4                        # kTile: batch rows per pass of the dot, B > 1
MAX_CLUSTER = 16                # kMaxCluster: blocks per cluster (non-portable)
SMEM_MAX = 232_448              # kMaxSmem: shared memory a block may use
BARRIER_BYTES = 16              # kBarrierBytes: its static part, two mbarriers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_OCC_ARGTYPES = (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
_BWD_OCC_ARGTYPES = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
BWD_STAGES = 3                  # kStages in csrc/slstm_scan_bwd.cu: the ring's steps
BWD_WARP_ROWS = 64              # kWarpRows: rows of R one warp's product covers


class SlstmPlan(NamedTuple):
    """One head's cluster: ``blocks`` (G) blocks of ``units`` units each;
    the dot's ``segments`` row segments; ``tile`` batch rows per pass; the
    first ``resident_rows`` rows of the R slice in shared memory (the rest
    read from device memory every step); ``smem_bytes`` of dynamic shared
    memory per block."""
    blocks: int
    units: int
    segments: int
    tile: int
    resident_rows: int
    smem_bytes: int


def slstm_plan(B: int, nh: int, dh: int, r_dtype) -> SlstmPlan:
    """The kernel's launch plan for wx [B,T,nh,4dh] and r [nh,dh,4dh] of
    ``r_dtype``; raises ``ValueError`` with the reason for a shape the
    kernel cannot take.

    32 units per block (16 where dh is not a multiple of 32): their 128
    gate columns are 16 column groups of 8, so one warp's load of the R
    slice reads two whole 256-byte rows, and a warp's 32 gate entries are 8
    whole units. G = dh / units is then at most 16 (the largest cluster)
    up to dh = 512. The dot takes as many row segments (a power of two)
    as 256 threads and float4 reads of h allow. Shared memory holds the R
    slice, h twice (the exchange's double buffer), the warps' partial dots,
    (c, n, m) and two mbarriers; an fp32 slice at dh = 512 does not fit,
    and its rows beyond what fits, in whole warps' rows, are read from L2.
    """
    if r_dtype not in _DTYPES:
        raise ValueError(f"slstm_scan: r must be float32 or bfloat16, got {r_dtype}")
    if not 1 <= B <= MAX_BATCH or nh < 1:
        raise ValueError(f"slstm_scan: needs 1 <= B <= {MAX_BATCH} and nh >= 1, "
                         f"got B={B} nh={nh}")
    if dh % 16:
        raise ValueError(f"slstm_scan: needs dh % 16 == 0 (units per block "
                         f"of 16 or 32), got dh={dh}")
    units = 32 if dh % 32 == 0 else 16
    blocks = dh // units
    if blocks > MAX_CLUSTER:
        raise ValueError(f"slstm_scan: dh={dh} needs {blocks} blocks of "
                         f"{units} units per head, more than a cluster's "
                         f"{MAX_CLUSTER}")
    groups = units // 2
    segments = 1
    while segments * 2 * groups <= THREADS and dh % (8 * segments) == 0:
        segments *= 2
    warps = segments * groups // 32
    tile = 1 if B == 1 else TILE
    bpad = -(-B // tile) * tile
    fixed = 4 * (2 * bpad * dh + warps * tile * 4 * units + 3 * B * units)
    row_bytes = 4 * units * (2 if r_dtype == torch.bfloat16 else 4)
    warp_rows = 32 // groups * (dh // segments)
    room = SMEM_MAX - BARRIER_BYTES - fixed
    resident = min(dh, max(0, room) // row_bytes // warp_rows * warp_rows)
    smem = fixed + resident * row_bytes
    if smem + BARRIER_BYTES > SMEM_MAX:
        raise ValueError(f"slstm_scan: B={B} dh={dh} needs {smem} bytes of "
                         f"shared memory per block, more than {SMEM_MAX}")
    return SlstmPlan(blocks, units, segments, tile, resident, smem)


class SlstmBwdPlan(NamedTuple):
    """The backward walk's cluster per head: ``blocks`` (G) blocks of
    ``units`` units; ``tile`` batch rows per pass of the recurrent product
    (1, 2 or TILE); the first ``resident_rows`` rows of an fp32 R slice in
    shared memory (the rest read from device memory every step; bf16 R is
    held in registers: 0); ``smem_bytes`` of dynamic shared memory per
    block."""
    blocks: int
    units: int
    tile: int
    resident_rows: int
    smem_bytes: int


def slstm_bwd_plan(B: int, nh: int, dh: int, r_dtype,
                   wx_dtype=F32) -> SlstmBwdPlan:
    """``csrc/slstm_scan_bwd.cu``'s layout for the shapes the forward takes
    (``slstm_plan``'s G and units); raises ``ValueError`` with the reason
    for a shape it cannot take.

    Shared memory holds dpre_t of the block's units for the batch rows
    padded to the tile, the partial dots received (two buffers of B x dh
    fp32) and a ring of BWD_STAGES steps of pre (4 gates), (c, n, m) fp32
    and dhs (wx's dtype), B x units each; with bf16 r the tensor cores'
    operand (dpre's three bf16 terms, 16 rows a tile) and each warp's
    partial dots (3 tile rows of BWD_WARP_ROWS + 4), with fp32 r the R
    slice (unit-major, as the forward), its rows beyond what fits (a dh =
    512 slice does not), in whole warps' rows, read from L2."""
    units = slstm_plan(B, nh, dh, r_dtype).units
    if wx_dtype not in _DTYPES:
        raise ValueError(f"slstm_scan_bwd: wx must be float32 or bfloat16, "
                         f"got {wx_dtype}")
    cols = 4 * units
    tile = B if B <= 2 else TILE
    bpad = -(-B // tile) * tile
    w_size = 2 if wx_dtype == torch.bfloat16 else 4
    fixed = (4 * bpad * cols + 8 * B * dh
             + BWD_STAGES * B * units * (28 + w_size))
    resident = 0
    if r_dtype == torch.bfloat16:   # the tensor cores' operand and sums
        fixed += (2 * bpad // tile * 16 * cols
                  + 4 * THREADS // 32 * 3 * tile * (BWD_WARP_ROWS + 4))
    else:
        room = SMEM_MAX - BARRIER_BYTES - fixed
        row_bytes = 4 * cols
        resident = (dh if dh * row_bytes <= room else
                    max(0, room) // row_bytes // BWD_WARP_ROWS * BWD_WARP_ROWS)
    smem = fixed + resident * 4 * cols
    if smem + BARRIER_BYTES > SMEM_MAX:
        raise ValueError(f"slstm_scan_bwd: B={B} dh={dh} needs {smem} bytes "
                         f"of shared memory per block, more than {SMEM_MAX}")
    return SlstmBwdPlan(dh // units, units, tile, resident, smem)


def scalar_max(x, v: float):
    """``jnp.maximum(x, v)``: at a tie each side takes half the gradient
    (``torch.clamp`` would give the input all of it)."""
    return torch.maximum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def scalar_min(x, v: float):
    """``jnp.minimum(x, v)``, with the same tie rule as ``scalar_max``."""
    return torch.minimum(x, torch.full((), v, dtype=x.dtype, device=x.device))


def _cell(pre, c, n, m):
    """One step of the sLSTM cell from pre-activations [..., 4dh]:
    (c, n, m, h) after it."""
    i_r, f_r, z_r, o_r = pre.chunk(4, dim=-1)
    i_log = scalar_min(i_r, I_CLAMP)
    f_log = F.logsigmoid(f_r)
    m_new = torch.maximum(f_log + m, i_log)
    ig = torch.exp(i_log - m_new)
    fg = torch.exp(f_log + m - m_new)
    c = fg * c + ig * torch.tanh(z_r)
    n = fg * n + ig
    h = torch.sigmoid(o_r) * c / scalar_max(n, 1.0)
    return c, n, m_new, h


def slstm_scan_ref(wx, r, b):
    """Plain PyTorch version: the sequential scan of ``repro/kernels/ref.py:30``
    (``slstm_ref``), also returning the final state.

    wx: [B,T,nh,4dh] input projection, gate-major per head ([i, f, z, o]);
    r: [nh,dh,4dh]; b: [nh,4dh]. Returns (hs [B,T,nh,dh] in wx's dtype,
    (c, n, m, h) each [B,nh,dh] fp32), from c = n = h = 0 and m = -1e30.
    """
    B, T, nh, gd = wx.shape
    dh = gd // 4
    rf, bf = r.float(), b.float()
    zeros = torch.zeros(B, nh, dh, dtype=F32, device=wx.device)
    c, n, h = zeros, zeros, zeros
    m = torch.full((B, nh, dh), M_INIT, dtype=F32, device=wx.device)
    hs = []
    for t in range(T):
        rec = torch.einsum("bhd,hde->bhe", h, rf)
        c, n, m, h = _cell(wx[:, t].float() + rec + bf[None], c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1).to(wx.dtype), (c, n, m, h)


def _tie(x, y):
    """JAX's share of the gradient of max(x, y) that goes to x: 1 where x
    is the larger, 1/2 at a tie, else 0 (min(x, y): pass -x, -y)."""
    return (x > y).float() + 0.5 * (x == y).float()


def cell_bwd(pre, c, n, m, dh, dc_new, dn_new, dm_new):
    """The cell's local backward in fp32, as ``csrc/slstm_scan_bwd.cu``
    computes it: from the step's pre-activations [..., 4dh] and the state
    (c, n, m) before it, and the gradients of h and of the state after it,
    returns (dpre [..., 4dh], dc, dn, dm) of the state before it. The
    maximum that gives m_t, ``minimum(i, I_CLAMP)`` and ``maximum(n_t, 1)``
    split a tie's gradient in halves, as JAX's do."""
    i_r, f_r, z_r, o_r = pre.chunk(4, dim=-1)
    i_log = torch.minimum(i_r, torch.full_like(i_r, I_CLAMP))
    f_log = F.logsigmoid(f_r)
    a = f_log + m
    m_new = torch.maximum(a, i_log)
    ig = torch.exp(i_log - m_new)
    fg = torch.exp(a - m_new)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    c_new = fg * c + ig * z
    n_new = fg * n + ig
    nn = torch.maximum(n_new, torch.ones_like(n_new))
    do = dh * c_new / nn
    dc_t = dc_new + dh * o / nn
    dn_t = dn_new - dh * o * c_new / (nn * nn) * _tie(n_new, 1.0)
    dfg = dc_t * c + dn_t * n
    dig = dc_t * z + dn_t
    t_ig, t_fg = dig * ig, dfg * fg
    dm_t = dm_new - t_ig - t_fg
    share = _tie(a, i_log)
    da = t_fg + dm_t * share
    di = (t_ig + dm_t * (1.0 - share)) * _tie(-i_r, -I_CLAMP)
    dpre = torch.cat([di, da * torch.sigmoid(-f_r), dc_t * ig * (1.0 - z * z),
                      do * o * (1.0 - o)], dim=-1)
    return dpre, dc_t * fg, dn_t * fg, da


def slstm_scan_bwd_ref(wx, r, b, dhs, d_state=None):
    """Plain backward in fp32, the explicit formulas that
    ``csrc/slstm_scan_bwd.cu`` computes: the scan is run again to keep each
    step's pre-activations and state, then time is walked in reverse, with
    dh_t = dhs_t + R dpre_{t+1} and ``cell_bwd`` giving dpre_t and the
    state's gradients; dwx = dpre, db = sum of dpre over batch and time,
    dr = sum over steps of h_{t-1}^T dpre_t. ``d_state`` is the final (c,
    n, m, h)'s gradients (None, or None entries: zeros). Returns (dwx, dr,
    db) in wx's, r's and b's dtypes."""
    B, T, nh, gd = wx.shape
    dh = gd // 4
    rf, bf = r.float(), b.float()
    zeros = torch.zeros(B, nh, dh, dtype=F32, device=wx.device)
    states = [(zeros, zeros, torch.full_like(zeros, M_INIT), zeros)]
    pres = []
    for t in range(T):
        h = states[-1][3]
        pres.append(wx[:, t].float() + torch.einsum("bhd,hde->bhe", h, rf)
                    + bf[None])
        states.append(_cell(pres[-1], *states[-1][:3]))
    d_state = d_state or (None,) * 4
    dc, dn, dm, dh_final = (zeros if g is None else g.float() for g in d_state)
    dh_rec = dh_final
    dwx = torch.empty(B, T, nh, gd, dtype=F32, device=wx.device)
    dr = torch.zeros(nh, dh, gd, dtype=F32, device=wx.device)
    for t in reversed(range(T)):
        c, n, m, h_prev = states[t]
        dpre, dc, dn, dm = cell_bwd(pres[t], c, n, m,
                                    dhs[:, t].float() + dh_rec, dc, dn, dm)
        dwx[:, t] = dpre
        dr += torch.einsum("bhd,bhe->hde", h_prev, dpre)
        dh_rec = torch.einsum("bhe,hde->bhd", dpre, rf)
    db = dwx.sum(dim=(0, 1))
    return dwx.to(wx.dtype), dr.to(r.dtype), db.to(b.dtype)


def _check(wx, r, b):
    B, T, nh, gd = wx.shape if wx.dim() == 4 else (0, 0, 0, 0)
    dh = gd // 4
    if wx.dtype not in _DTYPES or wx.numel() == 0 or gd % 4:
        raise ValueError(f"slstm_scan: wx {tuple(wx.shape)} {wx.dtype}; takes "
                         "a non-empty [B,T,nh,4dh] float32 or bfloat16 tensor")
    for name, t, dtypes, shape in (("wx", wx, _DTYPES, (B, T, nh, gd)),
                                   ("r", r, _DTYPES, (nh, dh, gd)),
                                   ("b", b, (F32,), (nh, gd))):
        if (t.device != wx.device or t.dtype not in dtypes
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"slstm_scan: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; takes a contiguous {shape} of "
                             f"{[str(d) for d in dtypes]} on {wx.device}")
    return slstm_plan(B, nh, dh, r.dtype)


def _forward(wx, r, b, trace: bool = False):
    """(hs, (c, n, m, h)) on wx's device; with ``trace`` on a CUDA tensor
    also each step's pre-activations [B,T,nh,4dh] and (c, n, m, h) after
    it [4,B,T,nh,dh], fp32, for the backward (else None)."""
    if wx.device.type == "cpu":
        return slstm_scan_ref(wx, r, b), None
    plan = _check(wx, r, b)
    B, T, nh, gd = wx.shape
    dh = gd // 4
    hs = torch.empty(B, T, nh, dh, dtype=wx.dtype, device=wx.device)
    state = torch.empty(4, B, nh, dh, dtype=F32, device=wx.device)
    c, n, m, h = state.unbind(0)
    pre = steps = None
    if trace:
        pre = torch.empty(B, T, nh, gd, dtype=F32, device=wx.device)
        steps = torch.empty(4, B, T, nh, dh, dtype=F32, device=wx.device)
    if wx.device.type == "meta":
        work.FLOPS["slstm_scan"] += work.slstm_scan(
            B, T, nh, dh, wx.element_size(), r.element_size()).flops
        return (hs, (c, n, m, h)), (None if pre is None else (pre, steps))
    fn = build.function("slstm_scan_fwd", _ARGTYPES)
    with torch.cuda.device(wx.device):
        stream = torch.cuda.current_stream(wx.device).cuda_stream
        code = fn(wx.data_ptr(), r.data_ptr(), b.data_ptr(), hs.data_ptr(),
                  c.data_ptr(), n.data_ptr(), m.data_ptr(), h.data_ptr(),
                  None if pre is None else pre.data_ptr(),
                  None if steps is None else steps.data_ptr(),
                  _DTYPES[wx.dtype], _DTYPES[r.dtype], B, T, nh, dh,
                  plan.blocks, plan.segments, plan.resident_rows, stream)
    build.check(code, "slstm_scan")
    build.LAUNCHES["slstm_scan"] += 1
    return (hs, (c, n, m, h)), (None if pre is None else (pre, steps))


def slstm_scan(wx, r, b):
    """Arguments and results as ``slstm_scan_ref``; any T. On a CUDA tensor
    one launch of nh clusters of ``slstm_plan(...).blocks`` blocks; a
    cluster shape the card refuses raises. Differentiable in wx, r and b
    (``SlstmScan``)."""
    if wx.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"slstm_scan: no kernel for device {wx.device}")
    if torch.is_grad_enabled() and (wx.requires_grad or r.requires_grad
                                    or b.requires_grad):
        hs, c, n, m, h = SlstmScan.apply(wx, r, b)
        return hs, (c, n, m, h)
    return _forward(wx, r, b)[0]


class SlstmScan(torch.autograd.Function):
    """The forward (with its trace on the card) and ``slstm_scan_bwd``. A
    result the caller does not use comes back as a gradient of None, taken
    as zeros."""

    @staticmethod
    def forward(ctx, wx, r, b):
        ctx.set_materialize_grads(False)
        (hs, state), trace = _forward(wx, r, b, trace=True)
        ctx.save_for_backward(wx, r, b, *(trace or ()))
        return (hs, *state)

    @staticmethod
    def backward(ctx, dhs, *d_state):
        wx, r, b, *trace = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros(*wx.shape[:3], wx.shape[3] // 4, dtype=wx.dtype,
                              device=wx.device)
        return slstm_scan_bwd(wx, r, b, dhs.contiguous(), d_state,
                              trace=tuple(trace) or None)


def slstm_scan_bwd(wx, r, b, dhs, d_state=None, trace=None):
    """(dwx, dr, db) of ``slstm_scan`` at (wx, r, b), given the gradient of
    hs and of the final (c, n, m, h) (None entries: zeros), as
    ``slstm_scan_bwd_ref``.

    A CPU tensor takes ``slstm_scan_bwd_ref``. A CUDA tensor needs the
    forward's ``trace`` (pre-activations and per-step states); one launch of
    ``csrc/slstm_scan_bwd.cu``'s walk (``bwd_walk``), counted in
    ``LAUNCHES["slstm_scan_bwd"]``; dr, which the TPU kernel's body has no
    counterpart of, is one fp32 product over the stacked steps
    (sum_t h_{t-1}^T dpre_t, TF32 off)."""
    if wx.device.type == "cpu":
        return slstm_scan_bwd_ref(wx, r, b, dhs, d_state)
    if wx.device.type not in ("cuda", "meta"):
        raise ValueError(f"slstm_scan_bwd: no kernel for device {wx.device}")
    _check(wx, r, b)
    B, T, nh, gd = wx.shape
    dh = gd // 4
    if trace is None:
        raise ValueError("slstm_scan_bwd: a CUDA call needs the forward's "
                         "trace (SlstmScan saves it)")
    pre, steps = trace
    for name, t, shape, dtype in (
            ("dhs", dhs, (B, T, nh, dh), wx.dtype),
            ("pre", pre, (B, T, nh, gd), F32),
            ("steps", steps, (4, B, T, nh, dh), F32)):
        if (t.device != wx.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"slstm_scan_bwd: {name} is {tuple(t.shape)} "
                             f"{t.dtype}; takes a contiguous {shape} {dtype} "
                             f"on {wx.device}")
    d_state = d_state or (None,) * 4
    dstate = torch.zeros(3, B, nh, dh, dtype=F32, device=wx.device)
    for i, g in enumerate(d_state[:3]):      # dc, dn, dm of the final state
        if g is not None:
            dstate[i].copy_(g)
    if d_state[3] is not None:               # h_T is hs[:, -1]
        dhs = dhs.clone()
        dhs[:, -1] += d_state[3].to(dhs.dtype)
    if dhs.data_ptr() % 16:                  # the kernel copies 16 bytes
        dhs = dhs.clone()
    dpre, db = bwd_walk(r, pre, steps, dhs, dstate)
    h_prev = torch.cat([torch.zeros_like(steps[3, :, :1]), steps[3, :, :-1]],
                       dim=1)                # h_{t-1} [B,T,nh,dh]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # whatever the caller set
    try:
        dr = torch.einsum("btnd,btne->nde", h_prev, dpre)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if wx.device.type == "meta":          # the walk's work (dR: the einsum's)
        work.FLOPS["slstm_scan_bwd"] += work.slstm_scan_bwd(
            B, T, nh, dh, wx.element_size(), r.element_size()).flops
    return dpre.to(wx.dtype), dr.to(r.dtype), db.to(b.dtype)


def bwd_walk(r, pre, steps, dhs, dstate):
    """The kernel's walk alone: (dpre [B,T,nh,4dh], db [nh,4dh]) fp32 from
    the forward's trace, dhs (wx's dtype, 16-byte aligned) and the final
    state's (dc, dn, dm) [3,B,nh,dh]; one launch of nh clusters, counted in
    ``LAUNCHES["slstm_scan_bwd"]``."""
    B, T, nh, dh = dhs.shape
    plan = slstm_bwd_plan(B, nh, dh, r.dtype, dhs.dtype)
    dpre = torch.empty(B, T, nh, 4 * dh, dtype=F32, device=dhs.device)
    db = torch.empty(nh, 4 * dh, dtype=F32, device=dhs.device)
    if dhs.device.type == "meta":
        return dpre, db
    fn = build.function("slstm_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dhs.device):
        stream = torch.cuda.current_stream(dhs.device).cuda_stream
        code = fn(r.data_ptr(), pre.data_ptr(), steps.data_ptr(),
                  dhs.data_ptr(), dstate.data_ptr(), dpre.data_ptr(),
                  db.data_ptr(), _DTYPES[dhs.dtype], _DTYPES[r.dtype], B, T,
                  nh, dh, plan.blocks, plan.resident_rows, stream)
    build.check(code, "slstm_scan_bwd")
    build.LAUNCHES["slstm_scan_bwd"] += 1
    return dpre, db


def slstm_bwd_occupancy(B: int, nh: int, dh: int, wx_dtype, r_dtype) -> dict:
    """The backward walk's ``clusters`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``), its ``registers`` and local
    (``spill_bytes``) a thread and ``smem_bytes`` a block."""
    plan = slstm_bwd_plan(B, nh, dh, r_dtype, wx_dtype)
    out = (ctypes.c_int * 4)()
    fn = build.function("slstm_bwd_max_clusters", _BWD_OCC_ARGTYPES)
    code = fn(_DTYPES[wx_dtype], _DTYPES[r_dtype], B, nh, dh, plan.blocks,
              plan.resident_rows, ctypes.addressof(out))
    build.check(code, "slstm_bwd_max_clusters")
    return dict(zip(("clusters", "registers", "spill_bytes", "smem_bytes"),
                    out))


def slstm_max_clusters(B: int, nh: int, dh: int, wx_dtype, r_dtype) -> int:
    """How many of the kernel's clusters the current card holds at once
    (``cudaOccupancyMaxActiveClusters``); heads beyond it run in waves."""
    plan = slstm_plan(B, nh, dh, r_dtype)
    out = ctypes.c_int(0)
    fn = build.function("slstm_scan_max_clusters", _OCC_ARGTYPES)
    code = fn(_DTYPES[wx_dtype], _DTYPES[r_dtype], B, nh, dh, plan.blocks,
              plan.segments, plan.resident_rows, ctypes.addressof(out))
    build.check(code, "slstm_scan_max_clusters")
    return out.value

"""sLSTM time scan for Hopper: the CUDA kernel's wrapper, its launch plan and
its plain version.

``slstm_scan`` launches ``csrc/slstm_scan.cu`` on a CUDA tensor and runs
``slstm_scan_ref`` on a CPU tensor; nothing else. The kernel replaces the
Pallas TPU kernel ``repro/kernels/slstm_scan.py`` and also returns the final
(c, n, m, h) state, which prefill hands to decode: one thread-block cluster
per head, h exchanged through distributed shared memory (see the note at
the top of the CUDA source for what bounds it and how). ``slstm_plan``
chooses the cluster shape and the shared-memory layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

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
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_OCC_ARGTYPES = (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


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
        pre = wx[:, t].float() + rec + bf[None]
        i_r, f_r, z_r, o_r = pre.split(dh, dim=-1)
        i_log = torch.clamp(i_r, max=I_CLAMP)
        f_log = F.logsigmoid(f_r)
        m_new = torch.maximum(f_log + m, i_log)
        ig = torch.exp(i_log - m_new)
        fg = torch.exp(f_log + m - m_new)
        c = fg * c + ig * torch.tanh(z_r)
        n = fg * n + ig
        m = m_new
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1.0)
        hs.append(h)
    return torch.stack(hs, dim=1).to(wx.dtype), (c, n, m, h)


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


def slstm_scan(wx, r, b):
    """Arguments and results as ``slstm_scan_ref``; any T. On a CUDA tensor
    one launch of nh clusters of ``slstm_plan(...).blocks`` blocks; a
    cluster shape the card refuses raises."""
    if wx.device.type == "cpu":
        return slstm_scan_ref(wx, r, b)
    if wx.device.type != "cuda":
        raise ValueError(f"slstm_scan: no kernel for device {wx.device}")
    plan = _check(wx, r, b)
    B, T, nh, gd = wx.shape
    dh = gd // 4
    hs = torch.empty(B, T, nh, dh, dtype=wx.dtype, device=wx.device)
    state = torch.empty(4, B, nh, dh, dtype=F32, device=wx.device)
    c, n, m, h = state.unbind(0)
    fn = build.function("slstm_scan_fwd", _ARGTYPES)
    with torch.cuda.device(wx.device):
        stream = torch.cuda.current_stream(wx.device).cuda_stream
        code = fn(wx.data_ptr(), r.data_ptr(), b.data_ptr(), hs.data_ptr(),
                  c.data_ptr(), n.data_ptr(), m.data_ptr(), h.data_ptr(),
                  _DTYPES[wx.dtype], _DTYPES[r.dtype], B, T, nh, dh,
                  plan.blocks, plan.segments, plan.resident_rows, stream)
    build.check(code, "slstm_scan")
    build.LAUNCHES["slstm_scan"] += 1
    return hs, (c, n, m, h)


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

"""sLSTM time scan for Hopper: the CUDA kernel's wrapper and its plain
version.

``slstm_scan`` launches ``csrc/slstm_scan.cu`` on a CUDA tensor and runs
``slstm_scan_ref`` on a CPU tensor; nothing else. The kernel replaces the
Pallas TPU kernel ``repro/kernels/slstm_scan.py`` and also returns the final
(c, n, m, h) state, which prefill hands to decode (see the note at the top of
the CUDA source for what bounds it and how).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

F32 = torch.float32
I_CLAMP = 15.0
M_INIT = -1e30                  # the TPU kernel's initial m
UNITS = 16                      # units per block of the CUDA kernel
MAX_BATCH = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


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
    if dh % UNITS or B > MAX_BATCH:
        raise ValueError(f"slstm_scan: needs dh % {UNITS} == 0 and B <= "
                         f"{MAX_BATCH}, got dh={dh} B={B}")
    for name, t, dtypes, shape in (("wx", wx, _DTYPES, (B, T, nh, gd)),
                                   ("r", r, _DTYPES, (nh, dh, gd)),
                                   ("b", b, (F32,), (nh, gd))):
        if (t.device != wx.device or t.dtype not in dtypes
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"slstm_scan: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; takes a contiguous {shape} of "
                             f"{[str(d) for d in dtypes]} on {wx.device}")


def slstm_scan(wx, r, b):
    """Arguments and results as ``slstm_scan_ref``; any T. On a CUDA tensor
    one cooperative launch of nh * dh/16 blocks, which must all be resident
    at once (the launch fails otherwise)."""
    if wx.device.type == "cpu":
        return slstm_scan_ref(wx, r, b)
    if wx.device.type != "cuda":
        raise ValueError(f"slstm_scan: no kernel for device {wx.device}")
    _check(wx, r, b)
    B, T, nh, gd = wx.shape
    dh = gd // 4
    hs = torch.empty(B, T, nh, dh, dtype=wx.dtype, device=wx.device)
    state = torch.empty(4, B, nh, dh, dtype=F32, device=wx.device)
    hbuf = torch.empty(2, B, nh, dh, dtype=F32, device=wx.device)
    counters = torch.zeros(nh, dtype=torch.int32, device=wx.device)
    c, n, m, h = state.unbind(0)
    fn = build.function("slstm_scan_fwd", _ARGTYPES)
    with torch.cuda.device(wx.device):
        stream = torch.cuda.current_stream(wx.device).cuda_stream
        code = fn(wx.data_ptr(), r.data_ptr(), b.data_ptr(), hs.data_ptr(),
                  c.data_ptr(), n.data_ptr(), m.data_ptr(), h.data_ptr(),
                  hbuf.data_ptr(), counters.data_ptr(), _DTYPES[wx.dtype],
                  _DTYPES[r.dtype], B, T, nh, dh, stream)
    build.check(code, "slstm_scan")
    build.LAUNCHES["slstm_scan"] += 1
    return hs, (c, n, m, h)

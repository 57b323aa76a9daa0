"""SSD linear recurrence for Hopper: the CUDA kernels' wrapper and its plain
version.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` on a CUDA tensor and runs
``ssd_scan_ref`` on a CPU tensor; nothing else. The CUDA code replaces the
Pallas TPU kernel ``repro/kernels/ssd_scan.py`` with the same chunked form
in fp32 on the CUDA cores and adds what prefill needs and the TPU kernel
lacks: any T, an initial state, the final state, and the mLSTM normalizer
chain in the same call. B and C come per group ([b, T, G, N], G dividing
H). ``path`` picks one of two ways by shape and arguments alone: the
chunk-parallel path (three kernels: the chunks' products in parallel, one
ordered pass over the chunk states, the outputs in parallel) for states of
at most 64 x 64 without the normalizer (Mamba-2), else the ordered walk
(two kernels: the chunks' masked decay matrices, then the scan). See the
note at the top of the CUDA source for what bounds each and how.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_STATE_SIZES = (8, 16, 32, 64, 128, 256, 512)        # N the kernel is built for
CHUNK = 64                                           # kChunk in csrc/ssd_scan.cu
SMALL_STATE = 64                                     # kSmallState: N, P at most
_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_CHUNKS_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
                    + (ctypes.c_void_p,))


def ssd_scan_ref(x, a, B, C, *, initial_state=None, norm_weights=None,
                 initial_norm_state=None):
    """Plain PyTorch version: the sequential recurrence, one step at a time
    (``repro/models/ssm.py:133`` ``ssd_scan_ref``), with state in and out.

    x: [b,T,H,P]; a: [b,T,H] log decays; B/C: [b,T,G,N], G groups dividing
    H (head h reads group h // (H // G), as ``repeat_interleave`` expands
    them); initial_state: [b,H,N,P] or None (zeros). Returns (y [b,T,H,P] in x's
    dtype, final_state [b,H,N,P] fp32). With ``norm_weights`` w [b,T,H] it
    also runs the normalizer chain Sn_t = exp(a_t) Sn_{t-1} + w_t B_t,
    n_t = C_t . Sn_t (from ``initial_norm_state`` [b,H,N] or zeros) and
    returns (y, n [b,T,H] fp32, final_state, final_norm_state [b,H,N]).
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    rep = H // B.shape[2]
    xf, af = x.float(), a.float()
    Bf, Cf = (t.float().repeat_interleave(rep, dim=2) for t in (B, C))
    S = (torch.zeros(b, H, N, P, dtype=F32, device=x.device)
         if initial_state is None else initial_state.float())
    norm = norm_weights is not None
    if norm:
        wf = norm_weights.float()
        Sn = (torch.zeros(b, H, N, dtype=F32, device=x.device)
              if initial_norm_state is None else initial_norm_state.float())
    ys, ns = [], []
    for t in range(T):
        e = torch.exp(af[:, t])                                   # [b,H]
        S = e[:, :, None, None] * S + Bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], S))
        if norm:
            Sn = e[:, :, None] * Sn + Bf[:, t] * wf[:, t, :, None]
            ns.append((Cf[:, t] * Sn).sum(-1))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if not norm:
        return y, S
    return y, torch.stack(ns, dim=1), S, Sn


def path(N: int, P: int, norm: bool) -> str:
    """The kernels a call on the card runs, by shape and arguments alone:
    "chunks" (the chunk-parallel path) where one block holds a chunk's
    whole [N, P] state and there is no normalizer, else "walk" (the
    ordered walk over the chunks)."""
    return ("chunks" if not norm and N <= SMALL_STATE and P <= SMALL_STATE
            else "walk")


def _check(x, a, B, C, initial_state, norm_weights, initial_norm_state):
    b, T, H, P = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    G, N = B.shape[2:] if B.dim() == 4 else (0, 0)
    want = {"x": (x, x.dtype, (b, T, H, P)), "a": (a, F32, (b, T, H)),
            "B": (B, x.dtype, (b, T, G, N)), "C": (C, x.dtype, (b, T, G, N)),
            "initial_state": (initial_state, F32, (b, H, N, P)),
            "norm_weights": (norm_weights, F32, (b, T, H)),
            "initial_norm_state": (initial_norm_state, F32, (b, H, N))}
    if x.dtype not in _DTYPES or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} {x.dtype}; takes a "
                         "non-empty 4-d float32 or bfloat16 tensor")
    if N not in _STATE_SIZES:
        raise ValueError(f"ssd_scan: state size N={N} not in {_STATE_SIZES}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: B has {G} groups for {H} heads; takes "
                         "a group count that divides the heads")
    if initial_norm_state is not None and norm_weights is None:
        raise ValueError("ssd_scan: initial_norm_state without norm_weights")
    for name, (t, dtype, shape) in want.items():
        if t is None:
            continue
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; takes a contiguous {shape} "
                             f"{dtype} on {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssd_scan(x, a, B, C, *, initial_state=None, norm_weights=None,
             initial_norm_state=None):
    """Arguments and results as ``ssd_scan_ref``; any T. On a CUDA tensor
    one call computes y, the final state and, with ``norm_weights``, the
    normalizer chain, on the kernels ``path`` picks."""
    kw = dict(initial_state=initial_state, norm_weights=norm_weights,
              initial_norm_state=initial_norm_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, a, B, C, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check(x, a, B, C, **kw)
    out = _launch(path(B.shape[-1], x.shape[-1], norm_weights is not None),
                  x, a, B, C, **kw)
    build.LAUNCHES["ssd_scan"] += 1
    return out


def _launch(route, x, a, B, C, *, initial_state=None, norm_weights=None,
            initial_norm_state=None):
    """One call of the C entry of ``route`` ("chunks" or "walk") on checked
    CUDA tensors; returns as ``ssd_scan``."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    if route == "chunks" and norm_weights is not None:
        raise ValueError("ssd_scan: the chunk-parallel path has no "
                         "normalizer chain")
    y = torch.empty_like(x)
    S = torch.empty(b, H, N, P, dtype=F32, device=x.device)
    norm = norm_weights is not None
    n = torch.empty(b, T, H, dtype=F32, device=x.device) if norm else None
    Sn = torch.empty(b, H, N, dtype=F32, device=x.device) if norm else None
    chunks = -(-T // CHUNK)
    if route == "chunks":
        # per (batch*head, chunk) dS, then S_prev, [N, P]; per (batch*group,
        # chunk) C . B^T [CHUNK, CHUNK]; per (batch*head, chunk) exp(a_tot)
        size = b * chunks * (H * N * P + G * CHUNK * CHUNK + H)
    else:
        # per (batch*head, chunk): M [CHUNK, CHUNK] and two [CHUNK] decays
        size = b * H * chunks * CHUNK * (CHUNK + 2)
    ws = torch.empty(size, dtype=F32, device=x.device)
    # B and C are copied into shared memory 16 bytes at a time
    B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (B, C))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                _ptr(initial_state), y.data_ptr(), S.data_ptr())
        dims = (_DTYPES[x.dtype], b, T, H, G, N, P, stream)
        if route == "chunks":
            code = build.function("ssd_scan_chunks_fwd", _CHUNKS_ARGTYPES)(
                *head, ws.data_ptr(), *dims)
        else:
            code = build.function("ssd_scan_fwd", _ARGTYPES)(
                *head, _ptr(norm_weights), _ptr(initial_norm_state), _ptr(n),
                _ptr(Sn), ws.data_ptr(), *dims)
    build.check(code, "ssd_scan")
    return (y, n, S, Sn) if norm else (y, S)

"""The SSD linear-recurrence engine and the causal depthwise conv
(counterpart of the engine half of ``repro/models/ssm.py``; the Mamba-2
block itself is not ported yet).

For per-step scalar log-decays ``a`` and rank-N state updates

    S_t = exp(a_t) * S_{t-1} + B_t (x) x_t          (state  [H, N, P])
    y_t = C_t . S_t                                 (output [H, P])

``ssd_chunked`` is the JAX package's chunk-parallel form, kept plain for the
tests; the serving path runs the recurrence through the port's
``ssd_scan`` kernel (``kernels.ops.ssd``), whose plain version is
``ssd_scan_ref``. Decode advances one step with ``ssd_decode_step``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan_ref as _scan_ref

F32 = torch.float32


def _expand_groups(B, C, H: int):
    rep = H // B.shape[2]
    if rep > 1:
        B = B.repeat_interleave(rep, dim=2)
        C = C.repeat_interleave(rep, dim=2)
    return B.float(), C.float()


def _segsum(a):
    """a: [..., Q] log-decays -> L[..., i, j] = sum_{k=j+1..i} a_k (i >= j),
    -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return torch.where(mask, L, float("-inf"))


def ssd_chunked(x, a, B, C, chunk: int, initial_state=None,
                norm_weights=None, initial_norm_state=None):
    """Chunk-parallel SSD (``repro/models/ssm.py:43``), plain PyTorch.

    x: [b,T,H,P]; a: [b,T,H]; B/C: [b,T,G,N] (G groups broadcast to H
    heads); T % chunk == 0. Returns (y [b,T,H,P], final_state [b,H,N,P]), or
    with ``norm_weights`` [b,T,H] (y, n [b,T,H], final_state,
    final_norm_state [b,H,N]).
    """
    b, T, H, P = x.shape
    N = B.shape[3]
    assert T % chunk == 0, (T, chunk)
    nc = T // chunk
    Bf, Cf = _expand_groups(B, C, H)
    xf = x.float().reshape(b, nc, chunk, H, P)
    af = a.float().reshape(b, nc, chunk, H)
    Bf = Bf.reshape(b, nc, chunk, H, N)
    Cf = Cf.reshape(b, nc, chunk, H, N)

    # intra-chunk (diagonal) term
    L = torch.exp(_segsum(af.permute(0, 1, 3, 2)))               # [b,nc,H,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf) * L
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xf)

    # per-chunk states, then the recurrence over chunks
    a_cum = torch.cumsum(af, dim=2)                               # [b,nc,Q,H]
    a_tot = a_cum[:, :, -1]                                       # [b,nc,H]
    decay_to_end = torch.exp(a_tot[:, :, None] - a_cum)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bf, decay_to_end, xf)
    S = (torch.zeros(b, H, N, P, dtype=F32, device=x.device)
         if initial_state is None else initial_state.float())
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = torch.exp(a_tot[:, c])[:, :, None, None] * S + states[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                         # [b,nc,H,N,P]

    # inter-chunk (off-diagonal) term
    decay_from_start = torch.exp(a_cum)
    y_off = torch.einsum("bcqhn,bcqh,bchnp->bcqhp", Cf, decay_from_start,
                         S_prevs)
    y = (y_diag + y_off).reshape(b, T, H, P).to(x.dtype)
    if norm_weights is None:
        return y, S

    # P=1 normalizer chain, sharing the scores and decays
    wf = norm_weights.float().reshape(b, nc, chunk, H)
    n_diag = torch.einsum("bchqk,bckh->bcqh", scores, wf)
    nstates = torch.einsum("bcqhn,bcqh,bcqh->bchn", Bf, decay_to_end, wf)
    Sn = (torch.zeros(b, H, N, dtype=F32, device=x.device)
          if initial_norm_state is None else initial_norm_state.float())
    Sn_prevs = []
    for c in range(nc):
        Sn_prevs.append(Sn)
        Sn = torch.exp(a_tot[:, c])[:, :, None] * Sn + nstates[:, c]
    Sn_prevs = torch.stack(Sn_prevs, dim=1)                       # [b,nc,H,N]
    n_off = torch.einsum("bcqhn,bcqh,bchn->bcqh", Cf, decay_from_start,
                         Sn_prevs)
    return y, (n_diag + n_off).reshape(b, T, H), S, Sn


def ssd_scan_ref(x, a, B, C, initial_state=None):
    """Sequential form (``repro/models/ssm.py:133``): B/C [b,T,G,N] with
    groups; returns (y, final_state). The kernel's plain version does the
    work."""
    Bf, Cf = _expand_groups(B, C, x.shape[2])
    return _scan_ref(x, a, Bf, Cf, initial_state=initial_state)


def ssd_decode_step(S, x_t, a_t, B_t, C_t):
    """One step. S: [b,H,N,P]; x_t: [b,H,P]; a_t: [b,H]; B/C: [b,H,N].
    Returns (y [b,H,P] in x_t's dtype, new S)."""
    S = (torch.exp(a_t.float())[:, :, None, None] * S.float()
         + B_t.float()[:, :, :, None] * x_t.float()[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", C_t.float(), S)
    return y.to(x_t.dtype), S


def ssd_decode_norm_step(Sn, w_t, a_t, B_t, C_t):
    """Normalizer step. Sn: [b,H,N]; w_t: [b,H]; B/C: [b,H,N]. Returns
    (n [b,H] fp32, new Sn)."""
    Sn = (torch.exp(a_t.float())[:, :, None] * Sn.float()
          + B_t.float() * w_t.float()[:, :, None])
    return (C_t.float() * Sn).sum(-1), Sn


def causal_conv1d(x, w, b):
    """Depthwise causal conv, x: [B,T,D]; w: [D,K]; b: [D] -> x's shape and
    dtype. An explicit K-tap sum in fp32 (no cuDNN, so no TF32 on the card)."""
    K = w.shape[1]
    T = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    wf = w.float()
    out = xp[:, :T] * wf[:, 0]
    for k in range(1, K):
        out = out + xp[:, k:k + T] * wf[:, k]
    return (out + b.float()).to(x.dtype)


def conv_decode_step(conv_state, x_t, w, b):
    """conv_state: [B,K-1,D]; x_t: [B,1,D] -> (y_t [B,1,D], new state)."""
    window = torch.cat([conv_state, x_t], dim=1)                  # [B,K,D]
    y = torch.einsum("bkd,dk->bd", window.float(), w.float())
    y = (y + b.float()).to(x_t.dtype)[:, None]
    return y, window[:, 1:]

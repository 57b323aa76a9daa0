"""The SSD linear-recurrence engine, the causal depthwise conv and the
Mamba-2 block (counterpart of ``repro/models/ssm.py``).

For per-step scalar log-decays ``a`` and rank-N state updates

    S_t = exp(a_t) * S_{t-1} + B_t (x) x_t          (state  [H, N, P])
    y_t = C_t . S_t                                 (output [H, P])

``ssd_chunked`` is the JAX package's chunk-parallel form, kept plain for the
tests; the serving path runs the recurrence through the port's
``ssd_scan`` kernel (``kernels.ops.ssd``), whose plain version is
``ssd_scan_ref``. Decode advances one step with ``ssd_decode_step``.

The Mamba-2 block (zamba2) runs its recurrence through the same kernel at
any T, with B and C in fp32 per group (the kernel reads each head's group;
no copy per head); JAX's prefill falls back to the sequential ``ssd_scan_ref``
where T is not a multiple of its chunk. Decode stays plain torch
(``conv_decode_step``, ``ssd_decode_step``), as in the JAX package: no TPU
kernel covers it. ``A_log``, ``D`` and ``dt_bias`` are fp32 in every model,
as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: F401

from .common import dense_init, matmul, normal_init, rms_norm, uniform_init

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


# --------------------------------------------------------------------------
# Mamba-2 block
# --------------------------------------------------------------------------
def mamba2_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, nheads, conv_dim


def init_mamba2_params(generator, cfg, dtype, device, lead=()):
    """Separate input projections (w_z / w_x / w_B / w_C / w_dt), as the JAX
    package keeps them, with its distributions."""
    d, K = cfg.d_model, cfg.ssm_conv
    d_in, nheads, conv_dim = mamba2_dims(cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    dense = lambda i, o: dense_init(generator, i, o, dtype, device, lead=lead)
    u = uniform_init(generator, (*lead, nheads), device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    heads = torch.arange(1, nheads + 1, dtype=F32, device=device)
    return {
        "w_z": dense(d, d_in),
        "w_x": dense(d, d_in),
        "w_B": dense(d, GN),
        "w_C": dense(d, GN),
        "w_dt": dense(d, nheads),
        "conv_w": normal_init(generator, (*lead, conv_dim, K),
                              1.0 / math.sqrt(K), dtype, device),
        "conv_b": torch.zeros(*lead, conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(heads).expand(*lead, nheads).clone(),
        "D": torch.ones(*lead, nheads, dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),      # softplus^-1(dt0)
        "norm": torch.ones(*lead, d_in, dtype=dtype, device=device),
        "out_proj": dense(d_in, d),
    }


def _mamba2_proj(p, x):
    """x: [B, T, d] -> (z, dt, conv_in [B, T, conv_dim]) through the
    separate projections; conv_in is [x | B | C]."""
    conv_in = torch.cat([matmul(x, p["w_x"]), matmul(x, p["w_B"]),
                         matmul(x, p["w_C"])], dim=-1)
    return matmul(x, p["w_z"]), matmul(x, p["w_dt"]), conv_in


def _mamba2_heads(p, cfg, conv_y, dt, dtype):
    """The conv's output (before silu) and the dt projection -> (xh
    [..., H, P] in ``dtype``, x_scaled fp32, a fp32 [..., H], B and C
    [..., G, N] in ``dtype``)."""
    d_in, nheads, _ = mamba2_dims(cfg)
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_y = F.silu(conv_y.float()).to(dtype)
    xc, Bc, Cc = torch.split(conv_y, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])                       # log decay
    xh = xc.reshape(*xc.shape[:-1], nheads, cfg.ssm_head_dim)
    x_scaled = xh.float() * dt[..., None]
    return (xh, x_scaled, a, Bc.reshape(*Bc.shape[:-1], G, N),
            Cc.reshape(*Cc.shape[:-1], G, N))


def _mamba2_output(p, cfg, y, xh, z):
    """y: [..., H, P] fp32 from the recurrence -> the block's output."""
    d_in = mamba2_dims(cfg)[0]
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(*y.shape[:-2], d_in).to(z.dtype)
    y = rms_norm(y * F.silu(z.float()).to(z.dtype), p["norm"], cfg.norm_eps)
    return matmul(y, p["out_proj"])


def mamba2_scan(p, cfg, x):
    """x: [B, T, d] -> (out [B, T, d], conv_in [B, T, conv_dim], final ssm
    state [B, H, N, P] fp32): the recurrence over the whole sequence in one
    ``ssd_scan`` launch on the card, B and C per group."""
    z, dt, conv_in = _mamba2_proj(p, x)
    conv_y = causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
    xh, x_scaled, a, Bm, Cm = _mamba2_heads(p, cfg, conv_y, dt, x.dtype)
    y, state = ops.ssd(x_scaled, a, Bm.float(), Cm.float())
    return _mamba2_output(p, cfg, y, xh, z), conv_in, state


def mamba2_forward(p, cfg, x):
    """x: [B, T, d] -> [B, T, d] (training / prefill path; any T)."""
    return mamba2_scan(p, cfg, x)[0]


def init_mamba2_cache(cfg, batch: int, dtype, device, lead=()):
    d_in, nheads, conv_dim = mamba2_dims(cfg)
    return {"conv": torch.zeros(*lead, batch, cfg.ssm_conv - 1, conv_dim,
                                dtype=dtype, device=device),
            "ssm": torch.zeros(*lead, batch, nheads, cfg.ssm_state,
                               cfg.ssm_head_dim, dtype=F32, device=device)}


def mamba2_decode(p, cfg, x, cache):
    """x: [B, 1, d]; cache {conv, ssm} -> (y [B, 1, d], new cache)."""
    z, dt, conv_in = _mamba2_proj(p, x)
    conv_y, new_conv = conv_decode_step(cache["conv"], conv_in, p["conv_w"],
                                        p["conv_b"])
    xh, x_scaled, a, Bm, Cm = _mamba2_heads(p, cfg, conv_y, dt, x.dtype)
    Bf, Cf = _expand_groups(Bm, Cm, xh.shape[2])
    y, new_ssm = ssd_decode_step(cache["ssm"], x_scaled[:, 0], a[:, 0],
                                 Bf[:, 0], Cf[:, 0])
    out = _mamba2_output(p, cfg, y[:, None], xh, z)
    return out, {"conv": new_conv, "ssm": new_ssm}

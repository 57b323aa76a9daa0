"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
(counterpart of ``repro/models/xlstm.py``).

mLSTM is the SSD recurrence with (q, k, v) in the (C, B, x) roles plus a
normalizer chain:

    C_t = f_t * C_{t-1} + i_t * (v_t k_t^T)     n_t = f_t * n_{t-1} + i_t * k_t
    h_t = (q_t . C_t) / max(|q_t . n_t|, 1)

with a sigmoid forget gate (log f <= 0) and a clamped exponential input
gate. Over a whole sequence it runs through the port's ``ssd_scan`` kernel
(``ops.ssd``: y and the normalizer in one launch); decode advances one step
in plain torch, as the JAX package does.

sLSTM mixes its scalar memory across time through per-head recurrent
weights; over a sequence it runs through the port's ``slstm_scan`` kernel
(``ops.slstm``), and decode steps ``_slstm_cell``. Casts mirror the JAX
package's at every step, so bf16 runs round where it rounds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.slstm_scan import scalar_max, scalar_min

from .common import (F32, dense_init, group_norm_heads, matmul, normal_init,
                     rms_norm)
from .ssm import causal_conv1d, conv_decode_step, ssd_decode_norm_step, \
    ssd_decode_step

I_CLAMP = 15.0


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------
def mlstm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = cfg.n_heads
    dv = d_in // nheads
    dqk = int(d_in * cfg.xlstm_qk_dim_factor) // nheads
    return d_in, nheads, dqk, dv


def init_mlstm_params(generator, cfg, dtype, device, lead=()):
    d, K = cfg.d_model, cfg.ssm_conv
    d_in, nh, dqk, dv = mlstm_dims(cfg)
    dense = lambda i, o: dense_init(generator, i, o, dtype, device, lead=lead)
    head = lambda dim: normal_init(generator, (*lead, d_in, nh, dim),
                                   1.0 / math.sqrt(d_in), dtype, device)
    full = lambda shape, v, dt: torch.full((*lead, *shape), v, dtype=dt,
                                           device=device)
    return {
        "up_x": dense(d, d_in),
        "up_z": dense(d, d_in),
        "conv_w": normal_init(generator, (*lead, d_in, K), 1.0 / math.sqrt(K),
                              dtype, device),
        "conv_b": full((d_in,), 0.0, dtype),
        "wq": head(dqk),
        "wk": head(dqk),
        "wv": head(dv),
        "w_if": dense(d_in, 2 * nh),
        "b_i": full((nh,), -2.0, F32),
        "b_f": full((nh,), 3.0, F32),            # sigmoid(3) ~ .95 decay
        "gn": full((dv,), 1.0, dtype),
        "down": dense(d_in, d),
    }


def _head_proj(x, w, out_dtype=None):
    """einsum("btd,dhn->bthn") with fp32 accumulation. x: [B,T,d_in];
    w: [d_in, nh, n]."""
    d_in, nh, n = w.shape
    return matmul(x, w.reshape(d_in, nh * n), out_dtype).reshape(
        *x.shape[:-1], nh, n)


def _gates(p, gif):
    """gif: [..., 2, nh] fp32 -> (log input gate, log forget gate)."""
    i_log = scalar_min(gif[..., 0, :] + p["b_i"], I_CLAMP)
    f_log = F.logsigmoid(gif[..., 1, :] + p["b_f"])              # <= 0
    return i_log, f_log


def _mlstm_qkvif(p, cfg, x):
    """x: [B, T, d] -> (xb, z, q, k, v, i_log, f_log, xconv); q/k/v in x's
    dtype, rounded from fp32 as the JAX package rounds them."""
    Bsz, T, _ = x.shape
    d_in, nh, dqk, dv = mlstm_dims(cfg)
    xb = matmul(x, p["up_x"])
    z = matmul(x, p["up_z"])
    xconv = F.silu(causal_conv1d(xb, p["conv_w"], p["conv_b"]).float()).to(x.dtype)
    q = _head_proj(xconv, p["wq"], F32).to(x.dtype)
    k = (_head_proj(xconv, p["wk"], F32) / math.sqrt(dqk)).to(x.dtype)
    v = _head_proj(xb, p["wv"], F32).to(x.dtype)
    gif = matmul(xb, p["w_if"], out_dtype=F32).reshape(Bsz, T, 2, nh)
    i_log, f_log = _gates(p, gif)
    return xb, z, q, k, v, i_log, f_log, xconv


def _mlstm_recurrence(q, k, v, i_log, f_log):
    """The matrix memory and its normalizer over the sequence, in fp32 (one
    ``ssd_scan`` launch on the card). Returns (y [B,T,H,dv], n [B,T,H],
    final state [B,H,dqk,dv], final normalizer state [B,H,dqk])."""
    ig = torch.exp(i_log)
    v_in = v.float() * ig[..., None]
    return ops.ssd(v_in, f_log, k.float(), q.float(), norm_weights=ig)


def _mlstm_output(p, cfg, y, n, z, Bsz, T):
    """y: [B,T,H,dv]; n: [B,T,H]; z: [B,T,d_in]."""
    d_in = mlstm_dims(cfg)[0]
    h = y.float() / scalar_max(n.abs(), 1.0)[..., None]
    h = group_norm_heads(h, p["gn"].float(), cfg.norm_eps)
    h = h.reshape(Bsz, T, d_in).to(z.dtype)
    h = h * F.silu(z.float()).to(z.dtype)
    return matmul(h, p["down"])


def mlstm_forward(p, cfg, x):
    """x: [B, T, d] -> [B, T, d] (any T)."""
    Bsz, T, _ = x.shape
    _, z, q, k, v, i_log, f_log, _ = _mlstm_qkvif(p, cfg, x)
    y, n, _, _ = _mlstm_recurrence(q, k, v, i_log, f_log)
    return _mlstm_output(p, cfg, y, n, z, Bsz, T)


def init_mlstm_cache(cfg, batch: int, dtype, device, lead=()):
    d_in, nh, dqk, dv = mlstm_dims(cfg)
    zeros = lambda *shape, dt: torch.zeros(*lead, batch, *shape, dtype=dt,
                                           device=device)
    return {"conv": zeros(cfg.ssm_conv - 1, d_in, dt=dtype),
            "ssm": zeros(nh, dqk, dv, dt=F32),
            "ssm_n": zeros(nh, dqk, dt=F32)}


def mlstm_decode(p, cfg, x, cache):
    """One token; returns (out [B,1,d], new cache), leaving ``cache`` as it
    was. q/k/v stay fp32 here, as in the JAX package."""
    Bsz = x.shape[0]
    d_in, nh, dqk, dv = mlstm_dims(cfg)
    xb = matmul(x, p["up_x"])
    z = matmul(x, p["up_z"])
    conv_y, new_conv = conv_decode_step(cache["conv"], xb, p["conv_w"],
                                        p["conv_b"])
    xconv = F.silu(conv_y.float()).to(x.dtype)
    q = _head_proj(xconv, p["wq"], F32)[:, 0]
    k = (_head_proj(xconv, p["wk"], F32) / math.sqrt(dqk))[:, 0]
    v = _head_proj(xb, p["wv"], F32)[:, 0]
    gif = matmul(xb[:, 0], p["w_if"], out_dtype=F32).reshape(Bsz, 2, nh)
    i_log, f_log = _gates(p, gif)
    ig = torch.exp(i_log)
    y, new_ssm = ssd_decode_step(cache["ssm"], v * ig[..., None], f_log, k, q)
    n, new_n = ssd_decode_norm_step(cache["ssm_n"], ig, f_log, k, q)
    out = _mlstm_output(p, cfg, y[:, None], n[:, None], z, Bsz, 1)
    return out, {"conv": new_conv, "ssm": new_ssm, "ssm_n": new_n}


# --------------------------------------------------------------------------
# sLSTM block
# --------------------------------------------------------------------------
def slstm_ff_dim(d: int) -> int:
    """Post-block FFN width: ~8d/3 rounded up to a multiple of 128
    (8 * 2048 / 3 = 5461 -> 5504)."""
    raw = (8 * d + 2) // 3
    return ((raw + 127) // 128) * 128


def init_slstm_params(generator, cfg, dtype, device, lead=()):
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    ff = slstm_ff_dim(d)
    dense = lambda i, o: dense_init(generator, i, o, dtype, device, lead=lead)
    ones = lambda n: torch.ones(*lead, n, dtype=dtype, device=device)
    b = torch.cat([torch.full((d,), -2.0), torch.full((d,), 3.0),
                   torch.zeros(2 * d)]).to(device)
    return {
        "w_in": dense(d, 4 * d),                                  # i, f, z, o
        "r": normal_init(generator, (*lead, nh, dh, 4 * dh),
                         1.0 / math.sqrt(dh), dtype, device),     # per head
        "b": b.expand(*lead, 4 * d).clone(),
        "gn": ones(dh),
        "ff_up": dense(d, ff),
        "ff_gate": dense(d, ff),
        "ff_down": dense(ff, d),
        "ff_ln": ones(d),
    }


def _slstm_cell(p, cfg, wx_t, state):
    """One timestep. wx_t: [B, 4d] global gate-major ([i(d), f(d), z(d),
    o(d)]); state: (c, n, m, h) each [B, d] fp32."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    c, n, m, h = state
    hr = h.reshape(-1, nh, dh)
    # r's output dim is (gate, dh) per head: lay it out gate-major to line
    # up with wx and b (a head-major reshape would wire head h into gate h)
    rec = torch.einsum("bhd,hde->bhe", hr.float(), p["r"].float())
    rec = rec.reshape(-1, nh, 4, dh).transpose(1, 2).reshape(-1, 4 * d)
    pre = wx_t.float() + rec + p["b"]
    i_r, f_r, z_r, o_r = pre.split(d, dim=-1)
    i_log = scalar_min(i_r, I_CLAMP)
    f_log = F.logsigmoid(f_r)
    m_new = torch.maximum(f_log + m, i_log)
    ig = torch.exp(i_log - m_new)
    fg = torch.exp(f_log + m - m_new)
    c_new = fg * c + ig * torch.tanh(z_r)
    n_new = fg * n + ig
    h_new = torch.sigmoid(o_r) * c_new / scalar_max(n_new, 1.0)
    return c_new, n_new, m_new, h_new


def _slstm_scan(p, cfg, x):
    """The time scan over x: [B, T, d] (one ``slstm_scan`` launch on the
    card). Returns (hs [B,T,nh,dh] fp32, final (c, n, m, h) each [B, d])."""
    Bsz, T, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    wx = matmul(x, p["w_in"], out_dtype=F32)                      # [B,T,4d]
    # global gate-major -> gate-major per head, the kernel's layout
    wx = wx.reshape(Bsz, T, 4, nh, dh).transpose(2, 3).reshape(Bsz, T, nh,
                                                               4 * dh)
    b = p["b"].reshape(4, nh, dh).transpose(0, 1).reshape(nh, 4 * dh)
    hs, state = ops.slstm(wx, p["r"], b)
    return hs, tuple(s.reshape(Bsz, d) for s in state)


def _slstm_output(p, cfg, h, dtype):
    """Group norm of h [..., nh, dh] and the post-block gated FFN."""
    hn = group_norm_heads(h, p["gn"].float(), cfg.norm_eps)
    hn = hn.reshape(*h.shape[:-2], cfg.d_model).to(dtype)
    h2 = rms_norm(hn, p["ff_ln"], cfg.norm_eps)
    up = matmul(h2, p["ff_up"])
    gate = F.gelu(matmul(h2, p["ff_gate"]).float(),
                  approximate="tanh").to(dtype)               # jax.nn.gelu
    return hn + matmul(gate * up, p["ff_down"])


def slstm_forward(p, cfg, x):
    """x: [B, T, d] -> [B, T, d] (any T)."""
    hs, _ = _slstm_scan(p, cfg, x)
    return _slstm_output(p, cfg, hs, x.dtype)


def init_slstm_cache(cfg, batch: int, dtype, device, lead=()):
    shape = (*lead, batch, cfg.d_model)
    zeros = lambda: torch.zeros(shape, dtype=F32, device=device)
    return {"c": zeros(), "n": zeros(),
            "m": torch.full(shape, float("-inf"), dtype=F32, device=device),
            "h": zeros()}


def slstm_decode(p, cfg, x, cache):
    """One token; returns (out [B,1,d], new cache), leaving ``cache`` as it
    was."""
    Bsz, _, d = x.shape
    nh = cfg.n_heads
    wx = matmul(x[:, 0], p["w_in"], out_dtype=F32)
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = _slstm_cell(p, cfg, wx, state)
    out = _slstm_output(p, cfg, h.reshape(Bsz, nh, d // nh), x.dtype)
    return out[:, None], {"c": c, "n": n, "m": m, "h": h}

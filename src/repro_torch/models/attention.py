"""GQA attention with QKV biases, qk-norm, RoPE, M-RoPE (qwen2-vl), a
sliding window and cross attention over an encoder's output (whisper)
(counterpart of ``repro/models/attention.py``, single device).

``attend`` sends ``attn_impl`` "pallas" and "chunked" (the JAX default, the
same flash schedule written in jnp) to the port's flash kernel, so the
serving path runs it on the card: causal self attention, the encoder's
non-causal self attention and the cross attention's prefill (T query rows
against S encoder frames); "naive" stays plain. Decode attention, the
cross attention's included, is plain torch, as in the JAX package: no TPU
kernel covers it.

Decode writes the new token's k/v into the cache tensors in place (the JAX
functions return updated copies), so a step never copies the whole cache.
A sliding-window model (mixtral) decodes against a rolling cache of
``window`` slots: position p lives in slot ``p % window``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import visible

from .common import apply_mrope, apply_rope, dense_init, matmul, rms_norm

NEG_INF = -1e30


def init_attn_params(generator, cfg, dtype, device, lead=(),
                     cross: bool = False):
    """Projections, QKV biases (zero) and, outside a cross attention,
    qk-norm gains (``repro/models/attention.py:30-46``)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(generator, d, qd, dtype, device, lead=lead),
        "wk": dense_init(generator, d, kvd, dtype, device, lead=lead),
        "wv": dense_init(generator, d, kvd, dtype, device, lead=lead),
        "wo": dense_init(generator, qd, d, dtype, device, lead=lead,
                         scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(*lead, qd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(*lead, kvd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(*lead, kvd, dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg, x, kv_x=None):
    """x: [B, T, d] -> q [B,T,H,hd], k/v [B,S,KV,hd], k and v from ``kv_x``
    (a cross attention's encoder output, S rows) or from x (S = T): biased
    (qwen2, whisper) after each product, then qk-normed (qwen3)."""
    kv_x = x if kv_x is None else kv_x
    B, T = x.shape[:2]
    S = kv_x.shape[1]
    q, k, v = matmul(x, p["wq"]), matmul(kv_x, p["wk"]), matmul(kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, cfg, pos, pos3=None):
    """RoPE at ``pos`` [B, T], or M-RoPE at ``pos3`` [3, B, T]; neither for
    a model with absolute positions (``rope_theta == 0``)."""
    if cfg.mrope_sections:
        if pos3 is None:
            raise ValueError(f"{cfg.name}: M-RoPE needs pos3 [3, B, T]")
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k


def attend_naive(q, k, v, *, causal: bool, window: int, q_offset: int = 0):
    """q: [B,T,H,hd], k/v: [B,S,KV,hd] -> [B,T,H,hd]. Materializes scores;
    a row with no visible key gets the mean of v, as in JAX's softmax."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd))
    ok = visible(T, S, q_offset, causal, window, q.device)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attend(q, k, v, cfg, *, causal: bool = True, q_offset: int = 0,
           impl=None):
    impl = impl or cfg.attn_impl
    if impl in ("pallas", "chunked"):
        return ops.attention(q, k, v, causal=causal,
                             window=cfg.sliding_window, q_offset=q_offset)
    if impl == "naive":
        return attend_naive(q, k, v, causal=causal, window=cfg.sliding_window,
                            q_offset=q_offset)
    raise ValueError(f"unknown attn_impl {impl!r}")


def attn_with_kv(p, cfg, x, *, pos, pos3=None, causal=True, kv_x=None,
                 use_rope=True):
    """Full-sequence attention through the flash kernel: (out [B, T, d],
    (k, v)). ``kv_x`` makes it a cross attention (S = kv_x's length);
    ``use_rope`` rotates q and k at ``pos`` / ``pos3``."""
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if use_rope:
        q, k = _rope_qk(q, k, cfg, pos, pos3)
    out = attend(q, k, v, cfg, causal=causal)
    B, T = x.shape[:2]
    return matmul(out.reshape(B, T, cfg.q_dim), p["wo"]), (k, v)


def attn_forward(p, cfg, x, *, pos, pos3=None, causal=True, kv_x=None,
                 use_rope=True):
    """Full-sequence attention (training, the encoder, a cross attention's
    prefill): [B, T, d]."""
    return attn_with_kv(p, cfg, x, pos=pos, pos3=pos3, causal=causal,
                        kv_x=kv_x, use_rope=use_rope)[0]


def attn_prefill(p, cfg, x, *, pos, pos3=None):
    """Full-sequence causal attention that also returns the (k, v) it made."""
    return attn_with_kv(p, cfg, x, pos=pos, pos3=pos3, causal=True)


def attn_decode(p, cfg, x, cache, *, cache_len, pos3=None,
                rolling: bool = False):
    """One-token decode. x: [B, 1, d]; cache: (k, v) [B, S, KV, hd].

    ``cache_len`` is the number of valid positions already in the cache: a
    scalar (every row writes the same slot, as JAX's dynamic-update-slice)
    or a per-row ``[B]`` tensor (continuous batching, a row scatter). The
    new token goes to slot ``cache_len % S`` when ``rolling`` (a sliding
    window of S slots) and to ``min(cache_len, S-1)`` otherwise; RoPE takes
    the absolute position ``cache_len`` either way, and M-RoPE takes
    ``pos3`` [3, B, 1] or, without it, ``cache_len`` on all three axes (as
    the JAX package's decode does). The cache is updated in place; returns
    (out [B,1,d], cache).
    """
    k_cache, v_cache = cache
    B, S = k_cache.shape[0], k_cache.shape[1]
    scalar = not (torch.is_tensor(cache_len) and cache_len.dim() == 1)
    cl = torch.as_tensor(cache_len, dtype=torch.long, device=x.device)
    cl = cl.expand(B) if scalar else cl
    q, k_new, v_new = _project_qkv(p, cfg, x)
    pos = cl[:, None]
    if cfg.mrope_sections and pos3 is None:
        pos3 = pos[None].expand(3, B, 1)
    q, k_new = _rope_qk(q, k_new, cfg, pos, pos3)
    if scalar:
        s0 = int(cache_len) % S if rolling else min(int(cache_len), S - 1)
        k_cache[:, s0] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, s0] = v_new[:, 0].to(v_cache.dtype)
    else:
        rows = torch.arange(B, device=x.device)
        slot = cl % S if rolling else torch.clamp(cl, max=S - 1)
        k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)

    # Grouped-query attention straight against the cache, never
    # materializing the head-repeated KV (JAX's decode_grouped_attn path;
    # its repeat-expand A/B baseline computes the same and is not ported).
    KV = cfg.n_kv_heads
    G = cfg.n_heads // KV
    scale = 1.0 / math.sqrt(cfg.head_dim)
    # slots written so far: rolling, min(cache_len + 1, S) (slot p % S for
    # position p); otherwise every slot up to cache_len
    last = torch.clamp(cl, max=S - 1) if rolling else cl
    valid = torch.arange(S, device=x.device)[None, :] <= last[:, None]  # [B,S]
    qg = q[:, 0].reshape(B, KV, G, cfg.head_dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    scores = torch.where(valid[:, None, None, :], scores * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).float(),
                       v_cache.float()).to(x.dtype)
    out = matmul(out.reshape(B, 1, cfg.q_dim), p["wo"])
    return out, (k_cache, v_cache)


def attn_decode_cross(p, cfg, x, enc_kv):
    """One-token cross attention against the encoder's precomputed (k, v)
    [B, S, KV, hd]: x [B, 1, d] -> [B, 1, d]. Plain, as JAX's
    ``attend_naive``."""
    B = x.shape[0]
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    out = attend_naive(q, k, v, causal=False, window=0)
    return matmul(out.reshape(B, 1, cfg.q_dim), p["wo"])


def cross_kv(p, cfg, enc_out):
    """The cross attention's k, v [B, S, KV, hd] from the encoder output."""
    B, S = enc_out.shape[:2]
    k, v = matmul(enc_out, p["wk"]), matmul(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device, lead=()):
    shape = (*lead, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

"""GQA attention with QKV biases, qk-norm, RoPE and a sliding window
(counterpart of ``repro/models/attention.py``, single device).

``attend`` sends ``attn_impl`` "pallas" and "chunked" (the JAX default, the
same flash schedule written in jnp) to the port's flash kernel, so the
serving path runs it on the card; "naive" stays plain. Decode attention is
plain torch, as in the JAX package: no TPU kernel covers it.

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

from .common import apply_rope, dense_init, matmul, rms_norm

NEG_INF = -1e30


def init_attn_params(generator, cfg, dtype, device, lead=()):
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
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg, x):
    """x: [B, T, d] -> q [B,T,H,hd], k/v [B,T,KV,hd]: biased (qwen2) after
    each product, then qk-normed (qwen3)."""
    B, T = x.shape[:2]
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, cfg, pos):
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    if cfg.rope_theta > 0:
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


def attn_prefill(p, cfg, x, *, pos):
    """Full-sequence causal attention that also returns the (k, v) it made."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope_qk(q, k, cfg, pos)
    out = attend(q, k, v, cfg, causal=True)
    B, T = x.shape[:2]
    return matmul(out.reshape(B, T, cfg.q_dim), p["wo"]), (k, v)


def attn_decode(p, cfg, x, cache, *, cache_len, rolling: bool = False):
    """One-token decode. x: [B, 1, d]; cache: (k, v) [B, S, KV, hd].

    ``cache_len`` is the number of valid positions already in the cache: a
    scalar (every row writes the same slot, as JAX's dynamic-update-slice)
    or a per-row ``[B]`` tensor (continuous batching, a row scatter). The
    new token goes to slot ``cache_len % S`` when ``rolling`` (a sliding
    window of S slots) and to ``min(cache_len, S-1)`` otherwise; RoPE takes
    the absolute position ``cache_len`` either way. The cache is updated in
    place; returns (out [B,1,d], cache).
    """
    k_cache, v_cache = cache
    B, S = k_cache.shape[0], k_cache.shape[1]
    scalar = not (torch.is_tensor(cache_len) and cache_len.dim() == 1)
    cl = torch.as_tensor(cache_len, dtype=torch.long, device=x.device)
    cl = cl.expand(B) if scalar else cl
    q, k_new, v_new = _project_qkv(p, cfg, x)
    q, k_new = _rope_qk(q, k_new, cfg, cl[:, None])
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


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device, lead=()):
    shape = (*lead, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

"""Blocks of the port: init / forward / prefill / decode / cache-init
(counterpart of ``repro/models/blocks.py``). Only the ATTN kind (attention +
dense MLP) is ported; other kinds raise.

Forwards return (x, aux) like the JAX package, aux being the MoE balance
loss there and always 0 here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attn_decode, attn_prefill, init_attn_params, init_kv_cache
from .common import rms_norm
from .mlp import init_mlp_params, mlp_forward


def _attn_only(kind: str):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def init_block(kind: str, generator, cfg, dtype, device, lead=()):
    """One block's params, or ``lead``-stacked params of several blocks."""
    _attn_only(kind)
    ones = lambda: torch.ones(*lead, cfg.d_model, dtype=dtype, device=device)
    return {"ln1": ones(),
            "attn": init_attn_params(generator, cfg, dtype, device, lead),
            "ln2": ones(),
            "mlp": init_mlp_params(generator, cfg, dtype, device, lead)}


def _attn_mlp(p, cfg, x, pos):
    a_out, kv = attn_prefill(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                             pos=pos)
    h = x + a_out
    return h + mlp_forward(p["mlp"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps)), kv


def block_forward(kind: str, p, cfg, x, *, pos):
    _attn_only(kind)
    return _attn_mlp(p, cfg, x, pos)[0], torch.zeros((), device=x.device)


def block_prefill(kind: str, p, cfg, x, *, pos, cache_size: int = 0):
    """Returns (x, cache); the (k, v) cache is zero-padded on the sequence
    axis up to ``cache_size`` slots, headroom for generated tokens."""
    _attn_only(kind)
    if cfg.sliding_window:
        raise NotImplementedError("rolling (sliding-window) caches are not "
                                  "ported yet")
    y, (k, v) = _attn_mlp(p, cfg, x, pos)
    pad = cache_size - x.shape[1]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return y, {"kv": (k, v)}


def block_decode(kind: str, p, cfg, x, cache, *, cache_len):
    """One token; the cache is updated in place and returned."""
    _attn_only(kind)
    a_out, kv = attn_decode(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                            cache["kv"], cache_len=cache_len)
    h = x + a_out
    y = h + mlp_forward(p["mlp"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps))
    return y, {**cache, "kv": kv}


def init_block_cache(kind: str, cfg, batch: int, cache_size: int, dtype,
                     device, lead=()):
    _attn_only(kind)
    return {"kv": init_kv_cache(cfg, batch, cache_size, dtype, device, lead)}

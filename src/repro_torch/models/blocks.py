"""Blocks of the port: init / forward / prefill / decode / cache-init
(counterpart of ``repro/models/blocks.py``). Kinds: ATTN (attention +
dense MLP, also zamba2's shared block and whisper's encoder blocks), MOE
(attention + MoE), MAMBA2, MLSTM and SLSTM. An ATTN block made with
``cross`` (whisper's decoder) adds a cross attention over the encoder's
output between the self attention and the MLP: ``ln_x`` and ``xattn``.

Forwards return (x, aux) like the JAX package, aux being the MoE balance
loss (0 for the other kinds). Decode updates the cache in place. A
sliding-window model's prefill leaves a rolling cache of ``cache_size``
slots, position p in slot ``p % cache_size``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ssm as S
from . import xlstm as X
from .attention import (attn_decode, attn_decode_cross, attn_forward,
                        attn_with_kv, cross_kv, init_attn_params,
                        init_kv_cache)
from .common import rms_norm, tree_map
from .mlp import init_mlp_params, init_moe_params, mlp_forward, moe_forward

# the recurrent kinds: a mixer after ln1, with a residual around it
_INIT = {"mamba2": S.init_mamba2_params, "mlstm": X.init_mlstm_params,
         "slstm": X.init_slstm_params}
_FORWARD = {"mamba2": S.mamba2_forward, "mlstm": X.mlstm_forward,
            "slstm": X.slstm_forward}
_DECODE = {"mamba2": S.mamba2_decode, "mlstm": X.mlstm_decode,
           "slstm": X.slstm_decode}
_CACHE = {"mamba2": S.init_mamba2_cache, "mlstm": X.init_mlstm_cache,
          "slstm": X.init_slstm_cache}


def _check_kind(kind: str):
    if kind not in ("attn", "moe") and kind not in _INIT:
        raise ValueError(f"unknown block kind {kind!r}")


def init_block(kind: str, generator, cfg, dtype, device, lead=(),
               cross: bool = False):
    """One block's params, or ``lead``-stacked params of several blocks;
    ``cross`` adds the enc-dec decoder block's cross attention."""
    _check_kind(kind)
    ones = lambda: torch.ones(*lead, cfg.d_model, dtype=dtype, device=device)
    if kind in _INIT:
        return {"ln1": ones(),
                "mixer": _INIT[kind](generator, cfg, dtype, device, lead)}
    p = {"ln1": ones(),
         "attn": init_attn_params(generator, cfg, dtype, device, lead),
         "ln2": ones()}
    if kind == "moe":
        p["moe"] = init_moe_params(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp_params(generator, cfg, dtype, device, lead)
    if cross:
        p["ln_x"] = ones()
        p["xattn"] = init_attn_params(generator, cfg, dtype, device, lead,
                                      cross=True)
    return p


def _ffn(p, cfg, hn, *, inference: bool):
    """The MLP or the MoE after ln2: (y, aux)."""
    if "moe" in p:
        return moe_forward(p["moe"], cfg, hn, inference=inference)
    return mlp_forward(p["mlp"], cfg, hn), torch.zeros((), device=hn.device)


def _attn_ffn(p, cfg, x, pos, pos3=None, enc_out=None, causal=True):
    """ATTN / MOE over a whole sequence: (y, aux, (k, v)). The self
    attention is causal but in an encoder; a decoder block with ``xattn``
    then attends to all of ``enc_out`` (non-causal, no RoPE)."""
    a_out, kv = attn_with_kv(p["attn"], cfg,
                             rms_norm(x, p["ln1"], cfg.norm_eps), pos=pos,
                             pos3=pos3, causal=causal)
    h = x + a_out
    if "xattn" in p:
        h = h + attn_forward(p["xattn"], cfg,
                             rms_norm(h, p["ln_x"], cfg.norm_eps), pos=pos,
                             causal=False, kv_x=enc_out, use_rope=False)
    y, aux = _ffn(p, cfg, rms_norm(h, p["ln2"], cfg.norm_eps), inference=False)
    return h + y, aux, kv


def block_forward(kind: str, p, cfg, x, *, pos, pos3=None, enc_out=None,
                  causal=True):
    _check_kind(kind)
    if kind in _FORWARD:
        y = _FORWARD[kind](p["mixer"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
        return x + y, torch.zeros((), device=x.device)
    y, aux, _ = _attn_ffn(p, cfg, x, pos, pos3, enc_out, causal)
    return y, aux


def _conv_state(xb, cfg):
    """The last K-1 inputs of the causal conv, zero-padded on the left for a
    prompt shorter than that (the conv's own padding)."""
    K1 = cfg.ssm_conv - 1
    return F.pad(xb[:, -K1:], (0, 0, max(K1 - xb.shape[1], 0), 0))


def _recurrent_prefill_mamba2(p, cfg, x):
    """Forward + final (conv, ssm) state (``repro/models/blocks.py:173``)."""
    out, conv_in, state = S.mamba2_scan(p, cfg, x)
    return out, {"conv": _conv_state(conv_in, cfg), "ssm": state}


def _recurrent_prefill_mlstm(p, cfg, x):
    """Forward + final (conv, ssm, ssm_n) state (``repro/models/blocks.py:206``).
    The conv state is the last K-1 inputs, zero-padded on the left for a
    prompt shorter than that (the causal conv's own padding)."""
    Bsz, T, _ = x.shape
    xb, z, q, k, v, i_log, f_log, _ = X._mlstm_qkvif(p, cfg, x)
    y, n, state, nstate = X._mlstm_recurrence(q, k, v, i_log, f_log)
    out = X._mlstm_output(p, cfg, y, n, z, Bsz, T)
    return out, {"conv": _conv_state(xb, cfg), "ssm": state, "ssm_n": nstate}


def _recurrent_prefill_slstm(p, cfg, x):
    """Forward + final (c, n, m, h) state (``repro/models/blocks.py:222``)."""
    hs, (c, n, m, h) = X._slstm_scan(p, cfg, x)
    return X._slstm_output(p, cfg, hs, x.dtype), {"c": c, "n": n, "m": m,
                                                  "h": h}


_PREFILLS = {"mamba2": _recurrent_prefill_mamba2,
             "mlstm": _recurrent_prefill_mlstm,
             "slstm": _recurrent_prefill_slstm}


def _rolling(t, W: int):
    """A prompt's [B, T, ...] keys or values as a rolling cache of W slots
    (``repro/models/blocks.py:124-135``): the last W positions, rolled so
    that position p sits in slot p % W, or zero-padded up to W."""
    T = t.shape[1]
    if T >= W:
        return torch.roll(t[:, -W:], T % W, dims=1)
    return F.pad(t, (0, 0, 0, 0, 0, W - T))


def block_prefill(kind: str, p, cfg, x, *, pos, pos3=None, enc_out=None,
                  cache_size: int = 0):
    """Returns (x, cache). For ATTN and MOE the (k, v) cache is zero-padded
    on the sequence axis up to ``cache_size`` slots, headroom for generated
    tokens, or with a sliding window is the rolling cache of ``cache_size``
    slots; a decoder block with a cross attention also keeps its k, v over
    ``enc_out`` (``xkv``); a recurrent kind's cache is its final state."""
    _check_kind(kind)
    if kind in _PREFILLS:
        y, cache = _PREFILLS[kind](p["mixer"], cfg,
                                   rms_norm(x, p["ln1"], cfg.norm_eps))
        return x + y, cache
    y, _, (k, v) = _attn_ffn(p, cfg, x, pos, pos3, enc_out)
    if cfg.sliding_window and cache_size:
        k, v = _rolling(k, cache_size), _rolling(v, cache_size)
    elif cache_size > x.shape[1]:
        pad = cache_size - x.shape[1]
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    cache = {"kv": (k, v)}
    if "xattn" in p:
        cache["xkv"] = cross_kv(p["xattn"], cfg, enc_out)
    return y, cache


def block_decode(kind: str, p, cfg, x, cache, *, cache_len,
                 rolling: bool = False):
    """One token; the cache is updated in place and returned. The MoE runs
    drop-free here (``inference``), as JAX's ``block_decode``; a decoder
    block's cross attention reads its ``xkv`` between the self attention
    and ln2."""
    _check_kind(kind)
    if kind in _DECODE:
        y, new = _DECODE[kind](p["mixer"], cfg,
                               rms_norm(x, p["ln1"], cfg.norm_eps), cache)
        tree_map(lambda old, val: old.copy_(val), cache, new)
        return x + y, cache
    a_out, kv = attn_decode(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                            cache["kv"], cache_len=cache_len, rolling=rolling)
    h = x + a_out
    if "xattn" in p:
        h = h + attn_decode_cross(p["xattn"], cfg,
                                  rms_norm(h, p["ln_x"], cfg.norm_eps),
                                  cache["xkv"])
    y, _ = _ffn(p, cfg, rms_norm(h, p["ln2"], cfg.norm_eps), inference=True)
    return h + y, {**cache, "kv": kv}


def init_block_cache(kind: str, cfg, batch: int, cache_size: int, dtype,
                     device, lead=(), cross: bool = False, enc_len: int = 0):
    """Zeros of a block's cache; ``cross`` adds ``xkv`` over ``enc_len``
    encoder frames."""
    _check_kind(kind)
    if kind in _CACHE:
        return _CACHE[kind](cfg, batch, dtype, device, lead)
    c = {"kv": init_kv_cache(cfg, batch, cache_size, dtype, device, lead)}
    if cross:
        c["xkv"] = init_kv_cache(cfg, batch, enc_len, dtype, device, lead)
    return c

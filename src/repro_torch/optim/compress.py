"""int8 block quantisation of gradients (counterpart of
``repro/optim/compress.py``, a copy in torch).

Blocks of 256 values share one fp32 scale, ``max |x| / 127`` clamped at
1e-12; values are rounded half to even (``torch.round``, as ``jnp.round``)
and clipped to [-127, 127]. The train step's ``grad_compress="int8"`` runs
``compress_residual`` on every gradient leaf and keeps the decoded value;
on one card there is no all-reduce for the int8 payload to shrink, so what
the port reproduces is the reference's arithmetic, which changes the
update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
BLOCK = 256


def int8_encode(x, block: int = BLOCK):
    """x: any-shape float -> (q int8 [n_blocks, block], scale fp32
    [n_blocks, 1], pad)."""
    flat = x.reshape(-1).to(F32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def int8_decode(q, scale, pad: int, shape, dtype=F32):
    flat = (q.to(F32) * scale).reshape(-1)
    if pad:
        flat = flat[:flat.shape[0] - pad]
    return flat.reshape(shape).to(dtype)


def compress_residual(x, block: int = BLOCK):
    """Quantize and return (decoded, residual) for error feedback."""
    q, scale, pad = int8_encode(x, block)
    dec = int8_decode(q, scale, pad, x.shape, x.dtype)
    return dec, (x.to(F32) - dec.to(F32)).to(x.dtype)

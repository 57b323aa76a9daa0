"""Shared primitives of the port: dtypes, matmul, RMSNorm, RoPE, activations
and init helpers (counterpart of ``repro/models/common.py``).

Params are nested dicts of tensors, weights stored ``[d_in, d_out]`` and
applied as ``x @ w``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

F32 = torch.float32


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over matching trees of dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------
# init helpers: the distributions of repro/models/common.py:25-31
# --------------------------------------------------------------------------
def _normal(shape, generator: torch.Generator, device):
    return torch.randn(shape, generator=generator, dtype=F32,
                       device=generator.device).to(device)


def dense_init(generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0, lead=()):
    """N(0, (scale / sqrt(d_in))^2) of shape ``lead + (d_in, d_out)``."""
    std = scale / math.sqrt(d_in)
    return (_normal((*lead, d_in, d_out), generator, device) * std).to(dtype)


def embed_init(generator, vocab: int, d: int, dtype, device):
    return (_normal((vocab, d), generator, device) * 0.02).to(dtype)


def matmul(x, w, out_dtype=None):
    """``x @ w`` with fp32 accumulation, cast to ``out_dtype`` (x's dtype by
    default); torch's bf16 matmul accumulates in fp32 on the card and the
    CPU alike."""
    return torch.matmul(x, w).to(out_dtype or x.dtype)


def rms_norm(x, gain, eps: float = 1e-6):
    """RMSNorm through the port's kernel (plain version on a CPU tensor).
    The kernel takes contiguous rows; ``h[:, -1:]`` of a batch is not."""
    return ops.norm(x.contiguous(), gain, eps=eps)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    raise NotImplementedError(f"activation {name!r} is not ported yet")


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def apply_rope(x, pos, theta: float):
    """x: [B, T, H, hd]; pos: [B, T] integer positions -> rotated x."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [half]
    angles = pos.to(F32)[..., None] * freqs                    # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

"""Shared primitives of the port: dtypes, matmul, RMSNorm, per-head group
norm, RoPE, M-RoPE, sinusoidal positions, activations and init helpers
(counterpart of ``repro/models/common.py``).

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


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in ``tree_map``'s
    order."""
    out = []
    tree_map(out.append, tree)
    return out


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------
# init helpers: the distributions of repro/models/common.py:25-31
# --------------------------------------------------------------------------
DRAW_ELEMENTS = 1 << 30      # the most fp32 values one draw makes


def is_meta(device) -> bool:
    """``device`` is the ``meta`` device: shapes and dtypes, no storage."""
    return torch.device(device).type == "meta"


def normal_init(generator, shape, std: float, dtype, device):
    """N(0, std^2) of ``shape``, drawn from ``generator`` on its own device
    and placed on ``device`` in ``dtype``. A tensor of more than
    ``DRAW_ELEMENTS`` values (a stack of full-width expert weights) is drawn
    a block of leading rows at a time, so its fp32 draw never needs more
    than 4 GiB beside the weights. On the ``meta`` device nothing is drawn
    and ``generator`` is not read (the counterpart of JAX's
    ``abstract_params``)."""
    shape = tuple(shape)
    if is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    if math.prod(shape) <= DRAW_ELEMENTS:
        x = torch.randn(shape, generator=generator, dtype=F32,
                        device=generator.device).to(device)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = DRAW_ELEMENTS // math.prod(shape[1:])
    if rows == 0:                       # one leading row is itself too big
        for i in range(shape[0]):
            out[i] = normal_init(generator, shape[1:], std, dtype, device)
        return out
    for i in range(0, shape[0], rows):
        out[i:i + rows] = normal_init(generator, out[i:i + rows].shape, std,
                                      dtype, device)
    return out


def uniform_init(generator, shape, device):
    """U[0, 1) fp32 of ``shape``, drawn from ``generator`` on its own device
    and placed on ``device``; nothing is drawn on the ``meta`` device."""
    if is_meta(device):
        return torch.empty(shape, dtype=F32, device=device)
    return torch.rand(shape, generator=generator, dtype=F32,
                      device=generator.device).to(device)


def dense_init(generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0, lead=()):
    """N(0, (scale / sqrt(d_in))^2) of shape ``lead + (d_in, d_out)``."""
    return normal_init(generator, (*lead, d_in, d_out), scale / math.sqrt(d_in),
                       dtype, device)


def embed_init(generator, vocab: int, d: int, dtype, device):
    return normal_init(generator, (vocab, d), 0.02, dtype, device)


def matmul(x, w, out_dtype=None):
    """``x @ w`` with fp32 accumulation, cast to ``out_dtype`` (x's dtype by
    default). torch's bf16 matmul accumulates in fp32 on the card and the
    CPU alike but rounds its result to bf16; where fp32 is asked for (JAX's
    ``preferred_element_type=F32``), the product is taken in fp32 so the
    accumulator itself comes out, not its bf16 rounding."""
    out_dtype = out_dtype or x.dtype
    if out_dtype == F32 and x.dtype != F32:
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w).to(out_dtype)


def rms_norm(x, gain, eps: float = 1e-6):
    """RMSNorm through the port's kernel (plain version on a CPU tensor).
    The kernel takes contiguous rows; ``h[:, -1:]`` of a batch is not."""
    return ops.norm(x.contiguous(), gain, eps=eps)


def group_norm_heads(x, gain, eps: float = 1e-6):
    """Per-head layer norm over the last dim (x: [..., H, hd]), in fp32,
    cast back to x's dtype (``repro/models/common.py:66``)."""
    h = x.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, unbiased=False)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * gain.float()).to(x.dtype)


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "squared_relu":            # nemotron's ungated MLP
        return lambda x: torch.square(F.relu(x))
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
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [half]
    return _rotate(x, pos.to(F32)[..., None] * freqs)          # [B, T, half]


def apply_mrope(x, pos3, theta: float, sections):
    """Qwen2-VL M-RoPE. x: [B, T, H, hd]; pos3: [3, B, T] (t, h, w) ids.
    The half-dim frequency bands are split into ``sections`` (t/h/w); each
    band takes its angle from its own position axis."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [half]
    angles = pos3.to(F32)[..., None] * freqs                   # [3, B, T, half]
    parts, start = [], 0
    for axis, sec in enumerate(sections):
        parts.append(angles[axis, :, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))                 # [B, T, half]


def _rotate(x, angles):
    """x rotated by ``angles`` [B, T, half] in fp32, back in x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# sinusoidal absolute positions (whisper)
# --------------------------------------------------------------------------
def sinusoid_at(pos, d: int):
    """Sinusoidal position rows at positions ``pos`` (a float tensor of any
    shape) -> [..., d]: sines then cosines of ``pos * inv``, as
    ``repro/models/model.py::_sinusoid_at``."""
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=F32,
                                                  device=pos.device))
    scaled = pos.to(F32)[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None):
    """Whisper-style sinusoidal absolute embeddings [n_pos, d], fp32."""
    return sinusoid_at(torch.arange(n_pos, dtype=F32, device=device), d)

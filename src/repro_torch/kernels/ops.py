"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``, without its ``INTERPRET`` switch).

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
PyTorch version; the model code calls only these two functions.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .rmsnorm import rmsnorm


def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def norm(x, gain, *, eps=1e-6):
    return rmsnorm(x, gain, eps=eps)


__all__ = ["attention", "norm"]

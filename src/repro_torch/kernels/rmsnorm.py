"""Fused RMSNorm for Hopper: the CUDA kernel's wrapper and its plain version.

``rmsnorm`` launches ``csrc/rmsnorm.cu`` on a CUDA tensor and runs
``rmsnorm_ref`` on a CPU tensor; nothing else. The kernel replaces the
Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (see the note at the top of
the CUDA source for what bounds it and how). It serves fp32 and bf16 at any
d; ``plan`` picks its path for the shape: 16-byte vector loads where the
pointers are 16-byte aligned and d a multiple of the vector, scalar loads
otherwise, and how many threads share a row.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_ARGTYPES = ((ctypes.c_void_p,) * 3
             + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float)
             + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_MAX_GROUP = 256          # threads per row at most (one block)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def plan(ptr: int, d: int, size: int):
    """The kernel's path for rows of ``d`` elements of ``size`` bytes at
    address ``ptr`` (pass the OR of every pointer the kernel reads or
    writes, so one misaligned one takes them all to the scalar path).

    Returns ``(vec, group, held)``: elements per load (16 bytes' worth, or
    1), threads per row (a power of two, at most 256), and whether the row
    fits in registers at two load units per thread (else it is streamed and
    read twice).
    """
    vec = 16 // size
    if ptr % 16 or d % vec:
        vec = 1
    units = d // vec
    group = min(_pow2(-(-units // 2)), _MAX_GROUP)     # NV = 2 in the .cu
    return vec, group, group * 2 >= units


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_ref(x, gain, *, eps: float = 1e-6):
    """Plain PyTorch version: ``x * rsqrt(mean(x^2) + eps) * gain`` in fp32,
    cast back to x's dtype (``repro/kernels/ref.py:25``)."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * gain.float()).to(x.dtype)


def rmsnorm(x, gain, *, eps: float = 1e-6):
    """x: [..., d]; gain: [d] -> x's shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gain, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or gain.dtype != x.dtype:
        raise ValueError(f"rmsnorm: x {x.dtype} and gain {gain.dtype}; takes "
                         "float32 or bfloat16, both alike")
    if gain.device != x.device or gain.shape != (d,):
        raise ValueError(f"rmsnorm: gain {tuple(gain.shape)} on {gain.device} "
                         f"for x {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and gain.is_contiguous()) or x.numel() == 0:
        raise ValueError("rmsnorm: x and gain must be contiguous and non-empty")
    out = torch.empty_like(x)
    vec, group, held = plan(x.data_ptr() | gain.data_ptr() | out.data_ptr(),
                            d, x.element_size())
    fn = build.function("rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), gain.data_ptr(), out.data_ptr(),
                  _DTYPES[x.dtype], x.numel() // d, d, eps, vec, group,
                  int(held), _sm_count(x.device.index), stream)
    build.check(code, "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return out

"""Fused RMSNorm for Hopper: the CUDA kernels' wrappers, their autograd
Function and their plain versions.

``rmsnorm`` launches ``csrc/rmsnorm.cu`` on a CUDA tensor and runs
``rmsnorm_ref`` on a CPU tensor; nothing else. The kernel replaces the
Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (see the note at the top of
the CUDA source for what bounds it and how). It serves fp32 and bf16 at any
d; ``plan`` picks its path for the shape: 16-byte vector loads where the
pointers are 16-byte aligned and d a multiple of the vector, scalar loads
otherwise, and how many threads share a row.

Where grad is enabled and x or the gain requires it, the call goes through
an ``autograd.Function`` whose backward is ``rmsnorm_bwd``: on the card the
kernels of ``csrc/rmsnorm_bwd.cu`` in fp32 and of ``csrc/rmsnorm_bwd_sm90.cu``
in bf16 (``bwd_plan`` picks the latter's layout), on CPU tensors the
explicit formulas of ``rmsnorm_bwd_ref``.

On the ``meta`` device (the dry-run's abstract evaluation) a call checks
as the card's path does, returns empty outputs, allocates the backward's
fp32 dg partial rows at their most (``META_SMS`` SMs, ``BWD_MAX_CLUSTERS``
clusters: the card's counts are not asked), adds its work to
``work.FLOPS`` and launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_ARGTYPES = ((ctypes.c_void_p,) * 3
             + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float)
             + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_BWD_ENTRY = {torch.float32: "rmsnorm_bwd",               # rmsnorm_bwd.cu
              torch.bfloat16: "rmsnorm_bwd_bf16"}         # rmsnorm_bwd_sm90.cu
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 6
                 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_float)
                 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_BWD_BF16_ARGTYPES = (_BWD_ARGTYPES[:9] + (ctypes.c_int,) * 3
                      + (ctypes.c_longlong, ctypes.c_void_p))
_MAX_GROUP = 256          # threads per row at most (one block)
_BWD_BLOCKS_PER_SM = 4    # rows of dg partial sums stay a small share of bytes
# rmsnorm_bwd_sm90.cu's constants
BWD_THREADS = 256         # threads per block
BWD_CLUSTER = 2           # blocks per thread-block cluster
BWD_MAX_CLUSTERS = 128    # clusters a launch takes at most
BWD_MAX_UNITS = 4         # 16-byte units a thread holds on the 16-byte path
BWD_SMEM_MAX = 232448 - 512    # dynamic shared memory of a block
_BWD_OCC_ARGTYPES = (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
META_SMS = 132            # an H100 SXM's SMs: the meta path's fp32 dg rows


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


def rmsnorm_bwd_ref(x, gain, dy, *, eps: float = 1e-6):
    """Plain backward in fp32, the formulas of ``csrc/rmsnorm_bwd.cu``: with
    r = rsqrt(mean(x^2) + eps) per row, dx = r * (g * dy) - x * r^3 *
    mean((g * dy) * x) and dg = sum over rows of dy * x * r. Returns (dx, dg)
    in x's and the gain's dtypes."""
    h, dyf = x.float(), dy.float()
    r = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    gdy = gain.float() * dyf
    dx = r * gdy - h * (r * r * r) * (gdy * h).mean(dim=-1, keepdim=True)
    dg = (dyf * h * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dg.to(gain.dtype)


def _check(x, gain, name):
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or gain.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype} and gain {gain.dtype}; takes "
                         "float32 or bfloat16, both alike")
    if gain.device != x.device or gain.shape != (d,):
        raise ValueError(f"{name}: gain {tuple(gain.shape)} on {gain.device} "
                         f"for x {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and gain.is_contiguous()) or x.numel() == 0:
        raise ValueError(f"{name}: x and gain must be contiguous and "
                         "non-empty")
    return d


def _forward(x, gain, eps):
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gain, eps=eps)
    d = _check(x, gain, "rmsnorm")
    out = torch.empty_like(x)
    vec, group, held = plan(x.data_ptr() | gain.data_ptr() | out.data_ptr(),
                            d, x.element_size())
    if x.device.type == "meta":
        work.FLOPS["rmsnorm"] += work.rmsnorm(x.numel() // d, d,
                                            x.element_size()).flops
        return out
    fn = build.function("rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), gain.data_ptr(), out.data_ptr(),
                  _DTYPES[x.dtype], x.numel() // d, d, eps, vec, group,
                  int(held), _sm_count(x.device.index), stream)
    build.check(code, "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return out


def bwd_blocks(rows: int, group: int, sms: int) -> int:
    """Blocks of the backward's first kernel: at most ``_BWD_BLOCKS_PER_SM``
    per SM, and as few as give every block the same number of row groups.
    Each writes one fp32 row of dg partial sums."""
    groups = -(-rows // (_MAX_GROUP // group))
    rounds = -(-groups // (_BWD_BLOCKS_PER_SM * sms))
    return -(-groups // rounds)


class BwdPlan(NamedTuple):
    """The layout of ``csrc/rmsnorm_bwd_sm90.cu`` for one call (see
    ``bwd_plan``)."""
    vec: int             # 8: the 16-byte path; 1: the scalar path
    group: int           # threads per row
    clusters: int        # clusters of BWD_CLUSTER blocks; rows of `partial`
    blocks: int
    rows_per_block: int  # block b owns rows [b * rows_per_block, ...)
    smem: int            # shared memory bytes the layout uses in a block


def bwd_vec_group(ptr: int, d: int):
    """(vec, group) of the bf16 backward for rows of ``d`` at address
    ``ptr`` (the OR of every pointer the kernel touches): the 16-byte path
    where every pointer is 16-byte aligned, d a multiple of 8 and a row at
    most ``BWD_MAX_UNITS`` 16-byte units a thread (d ≤ 8192), with G
    threads a row, a power of two from 8 to 256; else the scalar path with
    the forward's group for one-element units."""
    vec = 8
    if ptr % 16 or d % vec or d // vec > BWD_THREADS * BWD_MAX_UNITS:
        vec = 1
    units = d // vec
    if vec == 8:
        return vec, min(max(_pow2(-(-units // BWD_MAX_UNITS)), 8), BWD_THREADS)
    return vec, min(_pow2(-(-units // 2)), BWD_THREADS)


def bwd_plan(ptr: int, rows: int, d: int, max_clusters: int) -> BwdPlan:
    """The bf16 backward's layout for ``rows`` rows of ``d`` elements at
    address ``ptr`` on a card that holds ``max_clusters`` of its clusters at
    once (one block an SM; ``_max_clusters``).

    One wave: at most ``max_clusters`` clusters (and ``BWD_MAX_CLUSTERS``),
    fewer where the rows fill fewer passes (``BWD_THREADS / G`` rows a
    pass), each block a band of ``rows_per_block`` rows. Shared memory: on
    the 16-byte path one fp32 row of dg sums a warp (G < 32) or row slot,
    and the cluster's exchange buffer (``BWD_CLUSTER`` slices of
    ⌈d / BWD_CLUSTER⌉ floats); on the scalar path one row a row slot.
    """
    vec, group = bwd_vec_group(ptr, d)
    slots = BWD_THREADS // group
    clusters = max(1, min(max_clusters, BWD_MAX_CLUSTERS,
                          -(-rows // (slots * BWD_CLUSTER))))
    blocks = clusters * BWD_CLUSTER
    rows_per_block = -(-rows // blocks)
    if vec == 8:
        n_rows = BWD_THREADS // 32 if group < 32 else slots
        smem = n_rows * d * 4 + BWD_CLUSTER * -(-d // BWD_CLUSTER) * 4
    else:
        smem = slots * d * 4
    if smem > BWD_SMEM_MAX:
        raise ValueError(f"rmsnorm_bwd: d={d} too wide for the bf16 kernel's "
                         f"scalar path ({smem} bytes of shared memory)")
    return BwdPlan(vec, group, clusters, blocks, rows_per_block, smem)


@functools.cache
def _max_clusters(index: int, vec: int, group: int, d: int) -> int:
    """How many clusters of the bf16 backward's kernel for (vec, group, d)
    card ``index`` holds at once, one block an SM
    (``rmsnorm_bwd_bf16_max_clusters``)."""
    out = ctypes.c_int(0)
    fn = build.function("rmsnorm_bwd_bf16_max_clusters", _BWD_OCC_ARGTYPES)
    with torch.cuda.device(index):
        build.check(fn(vec, group, d, ctypes.byref(out)),
                    "rmsnorm_bwd_bf16_max_clusters")
    return out.value


def bwd_layout(ptr: int, rows: int, d: int, index: int) -> BwdPlan:
    """``bwd_plan`` on card ``index``, with as many clusters as it holds at
    once."""
    vec, group = bwd_vec_group(ptr, d)
    return bwd_plan(ptr, rows, d, _max_clusters(index, vec, group, d))


def rmsnorm_bwd(x, gain, dy, *, eps: float = 1e-6):
    """(dx, dg) of ``rmsnorm`` at (x, gain) for the output's gradient ``dy``.

    A CPU tensor takes ``rmsnorm_bwd_ref``; a CUDA tensor two kernels in its
    dtype (``LAUNCHES["rmsnorm_bwd"]`` counts the call once): in fp32 those
    of ``csrc/rmsnorm_bwd.cu`` (dx with per-block fp32 dg partial sums, then
    their sum), in bf16 those of ``csrc/rmsnorm_bwd_sm90.cu`` (dx with dg
    summed per thread, block and cluster, then the clusters' rows added);
    dg summed in fp32 in a fixed order and rounded once.
    """
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, gain, dy, eps=eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm_bwd: no kernel for device {x.device}")
    d = _check(x, gain, "rmsnorm_bwd")
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(f"rmsnorm_bwd: dy must be a contiguous "
                         f"{str(x.dtype)[6:]} {tuple(x.shape)} on {x.device}")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dg = torch.empty_like(gain)
    ptr = (x.data_ptr() | gain.data_ptr() | dy.data_ptr() | dx.data_ptr()
           | dg.data_ptr())
    meta = x.device.type == "meta"
    if x.dtype == torch.bfloat16:
        p = (bwd_plan(ptr, rows, d, BWD_MAX_CLUSTERS) if meta
             else bwd_layout(ptr, rows, d, x.device.index))
        sums, argtypes = p.clusters, _BWD_BF16_ARGTYPES
        layout = (p.vec, p.group, p.clusters, p.rows_per_block)
    else:
        vec, group, _ = plan(ptr, d, x.element_size())
        sums = bwd_blocks(rows, group,
                          META_SMS if meta else _sm_count(x.device.index))
        argtypes = _BWD_ARGTYPES
        layout = (vec, group, sums)
    partial = torch.empty(sums, d, dtype=torch.float32, device=x.device)
    if meta:
        work.FLOPS["rmsnorm_bwd"] += work.rmsnorm_bwd(rows, d,
                                                    x.element_size()).flops
        return dx, dg
    entry = _BWD_ENTRY[x.dtype]
    fn = build.function(entry, argtypes)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  dg.data_ptr(), partial.data_ptr(), rows, d, eps, *layout,
                  stream)
    build.check(code, entry)
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dg


class RMSNorm(torch.autograd.Function):
    """The forward kernel and ``rmsnorm_bwd``."""

    @staticmethod
    def forward(ctx, x, gain, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gain)
        return _forward(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, gain, dy.contiguous(), eps=ctx.eps)
        return dx, dg, None


def rmsnorm(x, gain, *, eps: float = 1e-6):
    """x: [..., d]; gain: [d] -> x's shape and dtype; differentiable in x
    and the gain."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or gain.requires_grad):
        return RMSNorm.apply(x, gain, eps)
    return _forward(x, gain, eps)

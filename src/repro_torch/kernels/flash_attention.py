"""Flash attention for Hopper: the CUDA kernels' wrapper and its plain version.

``flash_attention`` runs ``flash_attention_ref`` on a CPU tensor. On a CUDA
tensor the dtype alone picks the kernel: bf16 launches the tensor-core kernel
of ``csrc/flash_attention_sm90.cu`` (wgmma, TMA), fp32 the CUDA-core kernel
of ``csrc/flash_attention.cu`` (TF32 would break fp32's tolerance). Both
replace the Pallas TPU kernel ``repro/kernels/flash_attention.py`` (see the
notes at the top of the CUDA sources for what bounds them and how).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_void_p))
_ENTRY = {torch.float32: "flash_attention_fwd",          # CUDA cores
          torch.bfloat16: "flash_attention_sm90_fwd"}    # tensor cores


def visible(T: int, S: int, q_offset: int, causal: bool, window: int, device):
    """[T, S] bool: key s is visible from query row t (at t + q_offset)."""
    q_pos = torch.arange(T, device=device)[:, None] + q_offset
    k_pos = torch.arange(S, device=device)[None, :]
    ok = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """Plain PyTorch version of the kernel's contract, in fp32.

    q: [B,T,H,hd], k/v: [B,S,KV,hd] -> [B,T,H,hd] in q's dtype. Masked keys
    get no weight; a row with no visible key gives 0 (the TPU kernel's
    ``l == 0`` finalise).
    """
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    group = H // KV
    qf = q.float().transpose(1, 2)                              # [B,H,T,hd]
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    ok = visible(T, S, q_offset, causal, window, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype not in _ENTRY or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             "takes float32 or bfloat16, all alike")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(t.shape)}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 {name} at "
                             f"{t.data_ptr():#x} is not 16-byte aligned "
                             "(the tensor-core kernel loads it by TMA)")
    B, T, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    S, KV = k.shape[1], k.shape[2]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {_HEAD_DIMS}")
    if T == 0 or S == 0 or KV == 0 or H % KV or B * H > 65535:
        raise ValueError(f"flash_attention: cannot take T={T} S={S} H={H} "
                         f"KV={KV} B={B}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B,T,H,hd]; k/v: [B,S,KV,hd] -> [B,T,H,hd] (any T and S)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.function(_ENTRY[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, T, S, H, KV, hd, int(causal), int(window), int(q_offset),
                  1.0 / math.sqrt(hd), stream)
    build.check(code, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


def sm90_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the bf16 tensor-core kernel."""
    fn = build.function("flash_attention_sm90_smem_bytes", (ctypes.c_int,))
    return fn(hd)

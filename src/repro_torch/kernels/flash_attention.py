"""Flash attention for Hopper: the CUDA kernels' wrappers, their autograd
Function and their plain versions.

``flash_attention`` runs ``flash_attention_ref`` on a CPU tensor. On a CUDA
tensor the dtype alone picks the forward kernel: bf16 launches the
tensor-core kernel of ``csrc/flash_attention_sm90.cu`` (wgmma, TMA), fp32
the CUDA-core kernel of ``csrc/flash_attention.cu`` (16 warps, cp.async
double-buffered tiles; TF32 would break fp32's tolerance). Both take q, k
and v 16-byte aligned and replace the Pallas TPU kernel
``repro/kernels/flash_attention.py`` (see the notes at the top of the CUDA
sources for what bounds them and how).

Where grad is enabled and an input requires it, the call goes through an
``autograd.Function``: the forward then also writes each row's log-sum-exp
(both kernels can; serving asks neither to) and, in bf16, what rounding
the output to bf16 dropped (``o_lo``, for the backward's D = rowsum(do *
o): see ``csrc/flash_attention_sm90.cu``), and the backward
(``flash_attention_bwd``) launches, by the inputs' dtype, the CUDA-core
kernels of ``csrc/flash_attention_bwd.cu`` (fp32) or the tensor-core
kernels of ``csrc/flash_attention_bwd_sm90.cu`` (bf16). On CPU tensors the
same Function runs the plain forward and the plain backward
``flash_attention_bwd_ref``, explicit formulas rather than autograd of the
plain forward. Both forwards take hd 32, 64, 80, 128 and 192
(nemotron-4-340b; in bf16 a kernel of its own, three 64-row blocks an SM);
the bf16 backward 32, 64, 80 (zamba2's shared block, on 80-column tiles)
and 128, the fp32 backward 32, 64 and 128. A backward at another head_dim
on the card is not written yet and raises.

On the ``meta`` device (the dry-run's abstract evaluation, as
``jax.eval_shape``) each call checks what the card's path checks, raises
where it raises, returns empty outputs of the kernel path's shapes and
dtypes, allocates every buffer the card's path allocates, adds its work
to ``work.FLOPS`` and launches nothing: no plain version
runs there.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, work

NEG_INF = -1e30
_FWD_HEAD_DIMS = (32, 64, 80, 128, 192)
_BWD_HEAD_DIMS = {torch.float32: (32, 64, 128),
                  torch.bfloat16: (32, 64, 80, 128)}
_SCALARS = (ctypes.c_int,) * 9 + (ctypes.c_float, ctypes.c_void_p)
_ENTRY = {torch.float32: "flash_attention_fwd",          # CUDA cores
          torch.bfloat16: "flash_attention_sm90_fwd"}    # tensor cores
_ARGTYPES = {"flash_attention_fwd":                      # q, k, v, o, lse
             (ctypes.c_void_p,) * 5 + _SCALARS,
             "flash_attention_sm90_fwd":                 # q, k, v, o, o_lo, lse
             (ctypes.c_void_p,) * 6 + _SCALARS}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd",
              torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + _SCALARS      # q, k, v, o, lse, do,
#   dq, dk, dv, delta; the bf16 entry takes o's rounding residual after o
_BWD_BF16_ARGTYPES = (ctypes.c_void_p,) * 11 + _SCALARS
_OCC_ARGTYPES = (ctypes.c_int, ctypes.c_void_p)
BWD_HEAD_DIM = ("the flash_attention backward at head_dim {} in {} is not "
                "written yet (ROADMAP.md queue 2 item 1); it takes {}")


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
                        q_offset: int = 0, with_lse: bool = False,
                        with_residual: bool = False):
    """Plain PyTorch version of the kernel's contract, in fp32.

    q: [B,T,H,hd], k/v: [B,S,KV,hd] -> [B,T,H,hd] in q's dtype. Masked keys
    get no weight; a row with no visible key gives 0 (the TPU kernel's
    ``l == 0`` finalise). ``with_lse`` also returns each row's log-sum-exp of
    the scaled scores, fp32 [B,H,T], +inf for a row with no visible key;
    ``with_residual`` then also what rounding the fp32 output to q's dtype
    dropped, in q's dtype (the bf16 kernel's ``o_lo``).
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
    out32 = (torch.matmul(p, vf) / torch.where(l == 0, 1.0, l)).transpose(1, 2)
    out = out32.to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(l == 0, math.inf, m + torch.log(l))[..., 0]
    if not with_residual:
        return out, lse
    return out, lse, (out32 - out.float()).to(q.dtype)


def bwd_operands(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, o_lo=None):
    """The plain backward's fp32 operands: q, k and v (k and v repeated to
    q's heads) and do as [B,H,T or S,hd], P = exp(s - lse) on visible keys
    and dS = P * (do v^T - rowsum(do * o)) as [B,H,T,S] (o + ``o_lo``
    where the forward's rounding residual is given), and the scale."""
    T, H, hd = q.shape[1:]
    S, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = 1.0 / math.sqrt(hd)
    if o_lo is not None:
        o = o.float() + o_lo.float()
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))  # [B,H,T,hd]
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    ok = visible(T, S, q_offset, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    return qf, kf, dof, p, ds, scale


def per_kv_head(t, KV: int):
    """[B,H,S,hd] summed over each KV head's query heads -> [B,S,KV,hd]."""
    B, H, S, hd = t.shape
    return t.reshape(B, KV, H // KV, S, hd).sum(dim=2).transpose(1, 2)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            bf16_operands: bool = False, o_lo=None):
    """Plain backward in fp32, the formulas of ``csrc/flash_attention_bwd.cu``:
    with s = scale * q.k and P = exp(s - lse) on visible keys,
    dv = P^T do, dS = P * (do v^T - rowsum(do * o)), dq = scale * dS k,
    dk = scale * dS^T q; dk and dv summed over each KV head's query heads;
    o + ``o_lo`` in D where the forward's rounding residual is given.
    ``bf16_operands`` rounds P and dS to bf16 where the bf16 kernels of
    ``csrc/flash_attention_bwd_sm90.cu`` hand them to the tensor cores (P
    before P^T do, dS before dS k and dS^T q), every sum still in fp32.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    qf, kf, dof, p, ds, scale = bwd_operands(
        q, k, v, o, lse, do, causal=causal, window=window, q_offset=q_offset,
        o_lo=o_lo)
    if bf16_operands:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale         # [B,H,S,hd]
    dv = torch.matmul(p.transpose(-1, -2), dof)
    KV = k.shape[2]
    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk, KV).to(k.dtype),
            per_kv_head(dv, KV).to(v.dtype))


def _check(q, k, v, backward: bool = False):
    """Raises for what the kernels cannot take: ValueError for bad
    arguments, NotImplementedError (``backward``) for a head dim that only
    the forwards take."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {str(t.dtype)[6:]} {name} at "
                             f"{t.data_ptr():#x} is not 16-byte aligned "
                             "(the kernels load it by TMA or 16-byte "
                             "cp.async)")
    B, T, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    S, KV = k.shape[1], k.shape[2]
    if hd not in _FWD_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{_FWD_HEAD_DIMS}")
    if backward and hd not in _BWD_HEAD_DIMS[q.dtype]:
        raise NotImplementedError(BWD_HEAD_DIM.format(
            hd, str(q.dtype)[6:], _BWD_HEAD_DIMS[q.dtype]))
    if T == 0 or S == 0 or KV == 0 or H % KV or B * H > 65535:
        raise ValueError(f"flash_attention: cannot take T={T} S={S} H={H} "
                         f"KV={KV} B={B}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, causal, window, q_offset, with_lse):
    """(out, lse, out_lo): lse fp32 [B,H,T] when ``with_lse`` (training),
    else None (the kernel is then handed a null lse and writes none); out_lo
    when training in bf16, what rounding the output to bf16 dropped (the
    backward's D reads out + out_lo), else None. On the card the hd 192
    kernel, which has no backward, writes no out_lo."""
    residual = (with_lse and q.dtype == torch.bfloat16
                and (q.device.type == "cpu"
                     or q.shape[-1] in _BWD_HEAD_DIMS[torch.bfloat16]))
    if q.device.type == "cpu":
        if not with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset), None, None
        got = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, with_lse=True,
                                  with_residual=residual)
        return got if residual else (*got, None)
    _check(q, k, v)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    entry = _ENTRY[q.dtype]
    lse = (torch.empty(B, H, T, dtype=torch.float32, device=q.device)
           if with_lse else None)
    out_lo = torch.empty_like(q) if residual else None
    if q.device.type == "meta":
        work.FLOPS["flash_attention"] += work.flash_fwd(
            B, T, S, H, KV, hd, q.element_size(), causal, window,
            q_offset).flops
        return out, lse, out_lo
    residual = () if q.dtype == torch.float32 else (
        None if out_lo is None else out_lo.data_ptr(),)
    fn = build.function(entry, _ARGTYPES[entry])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *residual, None if lse is None else lse.data_ptr(), B, T, S,
                  H, KV, hd, int(causal), int(window), int(q_offset),
                  1.0 / math.sqrt(hd), _stream(q))
    build.check(code, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out, lse, out_lo


def _check_residual(q, o_lo):
    """A bf16 backward takes the forward's ``o_lo`` and an fp32 one none
    (an fp32 output has no rounding to undo)."""
    if (o_lo is None) == (q.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: o_lo, the forward's rounding "
                         f"residual, is taken in bfloat16 and only there; "
                         f"got {'none' if o_lo is None else 'one'} in "
                         f"{str(q.dtype)[6:]}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0, o_lo=None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), given its output
    ``o``, its fp32 ``lse`` [B,H,T] and the output's gradient ``do``; in
    bf16 also ``o_lo`` (required there, and taken nowhere else), what the
    forward's rounding of ``o`` dropped: D reads o + o_lo.

    A CPU tensor takes ``flash_attention_bwd_ref``; a CUDA tensor three
    kernels per call, D = rowsum(do * o) (o + o_lo in bf16), then dk/dv and
    dq, with no atomics, so the result is the same on every call: in fp32
    those of ``csrc/flash_attention_bwd.cu`` (CUDA cores, tiles by
    cp.async), in bf16 those of ``csrc/flash_attention_bwd_sm90.cu`` (wgmma
    on tiles placed by TMA, P and dS rounded to bf16 as
    ``flash_attention_bwd_ref(..., bf16_operands=True)`` rounds them).
    ``LAUNCHES["flash_attention_bwd"]`` counts the call once, whichever
    dtype; a ``meta`` tensor is checked and allocated as on the card and
    launches nothing; one at a head_dim its dtype's kernels do not take
    (``_BWD_HEAD_DIMS``: 80 in fp32, 192 in both) raises
    ``NotImplementedError`` before any launch. q, k, v, o and do share one
    dtype, fp32 or bf16, and lse is fp32. q, k, v and do must be 16-byte
    aligned (the kernels load them in 16-byte pieces or by TMA).
    """
    if q.device.type == "cpu":
        _check_residual(q, o_lo)
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, q_offset=q_offset,
                                       o_lo=o_lo)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    _check(q, k, v, backward=True)
    _check_residual(q, o_lo)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    checked = (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
               ("lse", lse, (B, H, T), torch.float32)) + (
        (("o_lo", o_lo, q.shape, q.dtype),) if bf16 else ())
    for name, t, shape, dtype in checked:
        if (t.shape != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {str(dtype)[6:]} {tuple(shape)} on "
                             f"{q.device}")
    if do.data_ptr() % 16:                   # q, k, v: _check
        raise ValueError(f"flash_attention_bwd: do at {do.data_ptr():#x} "
                         "is not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    if q.device.type == "meta":
        work.FLOPS["flash_attention_bwd"] += work.flash_bwd(
            B, T, S, H, KV, hd, q.element_size(), causal, window, q_offset,
            residual=bf16).flops
        return dq, dk, dv
    fn = build.function(_BWD_ENTRY[q.dtype],
                        _BWD_BF16_ARGTYPES if bf16 else _BWD_ARGTYPES)
    residual = (o_lo.data_ptr(),) if bf16 else ()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  *residual, lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, T, S, H,
                  KV, hd,
                  int(causal), int(window), int(q_offset),
                  1.0 / math.sqrt(hd), _stream(q))
    build.check(code, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel (with lse and, in bf16, the output's rounding
    residual) and ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse, out_lo = _forward(q, k, v, causal, window, q_offset,
                                    with_lse=True)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         o_lo=out_lo, **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B,T,H,hd]; k/v: [B,S,KV,hd] -> [B,T,H,hd] (any T and S);
    differentiable in q, k and v."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, with_lse=False)[0]


def fwd_occupancy(hd: int) -> dict:
    """Dynamic shared memory per block and blocks per SM of the fp32
    forward kernel at head dim ``hd`` on the current card."""
    out = (ctypes.c_int * 2)()
    fn = build.function("flash_attention_fwd_occupancy", _OCC_ARGTYPES)
    build.check(fn(hd, ctypes.addressof(out)), "flash_attention_fwd_occupancy")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1]}


def bwd_occupancy(hd: int, dtype=torch.float32) -> dict:
    """Dynamic shared memory per block and blocks per SM of the backward's
    dk/dv and dq kernels at head dim ``hd`` in ``dtype`` on the current
    card; in bf16 also each kernel's registers and local (spill) bytes a
    thread."""
    out = (ctypes.c_int * 8)()
    fn = build.function(f"{_BWD_ENTRY[dtype]}_occupancy", _OCC_ARGTYPES)
    build.check(fn(hd, ctypes.addressof(out)), "flash_attention_bwd_occupancy")
    occ = {"dkdv_smem_bytes": out[0], "dkdv_blocks_per_sm": out[1],
           "dq_smem_bytes": out[2], "dq_blocks_per_sm": out[3]}
    if dtype == torch.bfloat16:
        occ.update(dkdv_registers=out[4], dkdv_spill_bytes=out[5],
                   dq_registers=out[6], dq_spill_bytes=out[7])
    return occ


def sm90_occupancy(hd: int) -> dict:
    """The bf16 forward kernel that head dim ``hd`` launches: its dynamic
    shared memory per block, blocks per SM, registers a thread and
    local (spill) bytes a thread, on the current card."""
    out = (ctypes.c_int * 4)()
    fn = build.function("flash_attention_sm90_occupancy", _OCC_ARGTYPES)
    build.check(fn(hd, ctypes.addressof(out)), "flash_attention_sm90_occupancy")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1],
            "registers": out[2], "spill_bytes": out[3]}

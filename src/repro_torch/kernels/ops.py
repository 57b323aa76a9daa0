"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``, without its ``INTERPRET`` switch).

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
PyTorch version; the model code calls only these functions. They hand the
kernels contiguous tensors (the wrappers raise on any other).
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .rmsnorm import rmsnorm
from .slstm_scan import slstm_scan
from .ssd_scan import ssd_scan


def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def norm(x, gain, *, eps=1e-6):
    return rmsnorm(x, gain, eps=eps)


def _contiguous(t):
    return None if t is None else t.contiguous()


def ssd(x, a, B, C, *, initial_state=None, norm_weights=None,
        initial_norm_state=None):
    """SSD recurrence with state in and out (``ssd_scan``)."""
    return ssd_scan(x.contiguous(), a.contiguous(), B.contiguous(),
                    C.contiguous(), initial_state=_contiguous(initial_state),
                    norm_weights=_contiguous(norm_weights),
                    initial_norm_state=_contiguous(initial_norm_state))


def slstm(wx, r, b):
    """sLSTM time scan returning (hs, (c, n, m, h)) (``slstm_scan``)."""
    return slstm_scan(wx.contiguous(), r.contiguous(), b.contiguous())


__all__ = ["attention", "norm", "slstm", "ssd"]

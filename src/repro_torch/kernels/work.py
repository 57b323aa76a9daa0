"""What one call of each kernel computes and moves: its operations, its
bytes and the peak rate of the units it runs on, from which its bound
(the least time an H100 could take for the same work) follows.

One place for these counts: ``chip_smoke.py``'s bound and TFLOP/s columns
read them, and the wrappers' ``meta`` paths add each call's flops to
``FLOPS`` (by kernel name, as ``build.LAUNCHES`` counts launches), which
the dry-run (``launch/dryrun.py``) reads. A call counts
the flops of the visible (query, key) pairs, inputs read once and outputs
written once:

- flash forward: 4·B·H·hd·(visible pairs) over the bf16 tensor cores or
  the fp32 CUDA cores, e·(2·q + k + v) bytes; its backward 2.5x the
  flops, fp32 4·(4·q + 4·k + 2·lse) bytes, bf16 2·(4·q + 4·k) + 4·lse
  (+ 2·q with the forward's rounding residual);
- rmsnorm 4·rows·d flops, e·(2·rows·d + d) bytes; backward 8·rows·d,
  e·(3·rows·d + 2·d);
- ssd_scan 4·b·T·H·N·(P+1) flops (P with no normalizer), fp32; its
  backward 12·b·T·H·N·(P+1);
- slstm_scan 2·B·T·nh·dh·4dh + 20 per unit and step; its backward twice
  the product + 40.

e is the element size of the call's tensors. The peaks are the published
dense figures of one H100 SXM at its 700 W limit.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np

PEAK_BF16 = 989e12          # tensor cores, bf16 FLOP/s
PEAK_F32 = 67e12            # CUDA cores, fp32 FLOP/s
HBM = 3.35e12               # bytes/s

FLOPS: Counter = Counter()
"""Flops of the kernel calls evaluated on the ``meta`` device, by kernel
name (``LAUNCHES``' names); a caller resets it with ``FLOPS.clear()``."""


class Work(NamedTuple):
    flops: float
    bytes: float
    peak: float                 # FLOP/s of the units the kernel runs on

    def bound(self) -> dict:
        """{"operations": ms, "bytes": ms}: the flops over the peak and
        the bytes over HBM's rate."""
        return {"operations": self.flops / self.peak * 1e3,
                "bytes": self.bytes / HBM * 1e3}


def _peak(size: int) -> float:
    return PEAK_BF16 if size == 2 else PEAK_F32


def visible_pairs(T: int, S: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """The (t, s) pairs with key s visible from query row t (at position
    t + q_offset): under causal masking s <= t + q_offset and, with
    ``window``, s > t + q_offset - window; else all T * S."""
    if not causal:
        return T * S
    pos = np.arange(T, dtype=np.int64) + q_offset
    hi = np.minimum(pos, S - 1)
    lo = np.maximum(pos - window + 1, 0) if window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def visible_tiles(T: int, S: int, causal: bool, window: int,
                  tile: int = 64) -> int:
    """The (``tile``-row query tile, ``tile``-key tile) pairs holding a
    visible (t, s) pair at q_offset 0 (as ``visible_pairs`` sees them): the
    tile products the flash kernels run."""
    qt, kt = -(-T // tile), -(-S // tile)
    if not causal:
        return qt * kt
    t_lo = np.arange(qt, dtype=np.int64)[:, None] * tile
    t_hi = np.minimum(t_lo + tile - 1, T - 1)
    s_lo = np.arange(kt, dtype=np.int64)[None, :] * tile
    s_hi = np.minimum(s_lo + tile - 1, S - 1)
    ok = s_lo <= t_hi
    if window:
        ok &= s_hi > t_lo - window
    return int(ok.sum())


def flash_tile_flops(B, H, hd, tiles, tile: int = 64) -> int:
    """One ``tile`` x ``tile`` x hd product per head and batch row over
    ``tiles`` tile pairs (the kernels run S and P·V per pair forward, S,
    dP, dv and dk in the dk/dv kernel and S, dP and dq in the dq
    kernel)."""
    return 2 * tile * tile * hd * tiles * B * H


def flash_fwd(B, T, S, H, KV, hd, size, causal=True, window=0,
              q_offset=0) -> Work:
    pairs = visible_pairs(T, S, causal, window, q_offset)
    q, k = B * T * H * hd, B * S * KV * hd
    return Work(4 * B * H * hd * pairs, size * (2 * q + 2 * k), _peak(size))


def flash_bwd(B, T, S, H, KV, hd, size, causal=True, window=0, q_offset=0,
              residual=False) -> Work:
    pairs = visible_pairs(T, S, causal, window, q_offset)
    q, k, lse = B * T * H * hd, B * S * KV * hd, B * H * T
    if size == 4:
        nbytes = 4 * (4 * q + 4 * k + 2 * lse)
    else:
        nbytes = 2 * (4 * q + 4 * k) + 4 * lse + (2 * q if residual else 0)
    return Work(2.5 * 4 * B * H * hd * pairs, nbytes, _peak(size))


def rmsnorm(rows, d, size) -> Work:
    return Work(4 * rows * d, size * (2 * rows * d + d), PEAK_F32)


def rmsnorm_bwd(rows, d, size) -> Work:
    return Work(8 * rows * d, size * (3 * rows * d + 2 * d), PEAK_F32)


def ssd_scan(b, T, H, G, N, P, norm: bool) -> Work:
    """B and C counted as given, per group ([b, T, G, N]), each read once;
    the final state written once (+ the normalizer's w read and n
    written)."""
    cols = P + norm
    nbytes = 4 * (2 * b * T * H * P + b * T * H + 2 * b * T * G * N
                  + (2 * b * T * H if norm else 0) + b * H * N * cols)
    return Work(4 * b * T * H * N * cols, nbytes, PEAK_F32)


def ssd_scan_bwd(b, T, H, G, N, P, norm: bool) -> Work:
    """12 N (P+1) flops a step and head (the state and its gradient, 2
    each; dx, dB, dC and da, 2 each), or the inputs (x, a, B, C, dy, and w,
    dn with the normalizer) read once and their gradients written once."""
    cols = P + norm
    ins = (2 * b * T * H * P + b * T * H + 2 * b * T * G * N
           + (2 * b * T * H if norm else 0))
    return Work(12 * b * T * H * N * cols, 4 * 2 * ins, PEAK_F32)


def ssd_bwd_products(b, T, H, G, N, Pe) -> dict:
    """What each product kernel of ``ssd_scan_bwd`` computes at these sizes,
    in flops (2 a multiply-add, over whole 64-step chunks): C B^T and dy x^T
    (gram), dS and dG (state), Gin^T B and the chunk's dy sum (dx), Gin x or
    S_prev dy and the chunk's sum (dbc, both modes); and the pass's bytes
    (S_prev read and written forward; Gin read and written and S_prev read
    backward)."""
    L, nc = 64, -(-T // 64)
    bhc = b * H * nc
    return {"ssd_bwd_gram_kernel": 2 * L * L * (b * G * nc * N + bhc * Pe),
            "ssd_bwd_state_kernel": 2 * 2 * L * N * Pe * bhc,
            "ssd_bwd_dx_kernel": 2 * L * Pe * (N + L) * bhc,
            "ssd_bwd_dbc_kernel": 2 * 2 * L * N * (Pe + L) * bhc,
            "ssd_bwd_pass_kernel": 5 * 4 * N * Pe * bhc}


def slstm_scan(B, T, nh, dh, wx_size, r_size) -> Work:
    """The recurrence's multiply-adds plus ~20 gate operations a unit and
    step; wx, r and b read once, hs (fp32 count) and the final state
    written once."""
    gd = 4 * dh
    flops = 2 * B * T * nh * dh * gd + 20 * B * T * nh * dh
    nbytes = (B * T * nh * gd * wx_size + nh * dh * gd * r_size + 4 * nh * gd
              + 4 * B * T * nh * dh + 4 * 4 * B * nh * dh)
    return Work(flops, nbytes, PEAK_F32)


def slstm_scan_bwd(B, T, nh, dh, wx_size, r_size) -> Work:
    """The recurrent product R dpre and dR = sum h^T dpre, 2 B T nh dh 4dh
    flops each, ~40 gate operations a unit and step; or the forward's trace
    (pre-activations and per-step states), dhs and r read once and dwx, dr,
    db written once."""
    gd = 4 * dh
    flops = 4 * B * T * nh * dh * gd + 40 * B * T * nh * dh
    nbytes = (4 * (B * T * nh * gd + 4 * B * T * nh * dh) + 4 * B * T * nh * dh
              + 2 * nh * dh * gd * r_size + 4 * B * T * nh * gd + 8 * nh * gd)
    return Work(flops, nbytes, PEAK_F32)

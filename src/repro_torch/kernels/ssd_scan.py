"""SSD linear recurrence for Hopper: the CUDA kernels' wrapper and its plain
version.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` on a CUDA tensor and runs
``ssd_scan_ref`` on a CPU tensor; nothing else. The CUDA code replaces the
Pallas TPU kernel ``repro/kernels/ssd_scan.py`` with the same chunked form
in fp32 on the CUDA cores and adds what prefill needs and the TPU kernel
lacks: any T, an initial state, the final state, and the mLSTM normalizer
chain in the same call. B and C come per group ([b, T, G, N], G dividing
H). ``path`` picks one of two ways by shape and arguments alone: the
chunk-parallel path (three kernels: the chunks' products in parallel, one
ordered pass over the chunk states, the outputs in parallel) for states of
at most 64 x 64 without the normalizer (Mamba-2), else the ordered walk
(two kernels: the chunks' masked decay matrices, then the scan). See the
note at the top of the CUDA source for what bounds each and how.

Where grad is enabled and x, a, B, C or ``norm_weights`` requires it, the
call goes through an ``autograd.Function`` whose backward is
``ssd_scan_bwd``: on the card the kernels of ``csrc/ssd_scan_bwd.cu`` (fp32
only, as both call sites pass), on CPU tensors the explicit formulas of
``ssd_scan_bwd_ref``. ``initial_state`` and ``initial_norm_state`` are
constants to it: one that requires grad raises.

The workspaces are sized, and the shapes the C entries refuse are refused,
by ``fwd_workspace_floats`` and ``bwd_workspace_floats`` on every device:
the one place for them on this side (``chip_smoke.py``'s phase 2 holds
both against the C entries). On the ``meta`` device (the dry-run's
abstract evaluation) a call checks what the card's path checks, raises
where the card would (a refused shape as ``RuntimeError``), returns empty
outputs, allocates every buffer the card's path allocates, adds its work
to ``work.FLOPS`` and launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, work

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}      # ReproDtype in common.cuh
_STATE_SIZES = (8, 16, 32, 64, 128, 256, 512)        # N the kernel is built for
CHUNK = 64                                           # kChunk in csrc/ssd_scan.cu
SMALL_STATE = 64                                     # kSmallState: N, P at most
_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_CHUNKS_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
                    + (ctypes.c_void_p,))
_BWD_ARGTYPES = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_BWD_WS_ARGTYPES = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_BWD_OCC_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
BWD_PRODUCTS = ("gram", "state", "dx", "dbc")         # ssd_scan_bwd_occupancy's order
WALK_TILE = 32                                       # kTile: state columns a block
SUM_BLOCK = 8                                        # kSumBlock
GRID_LIMIT = 65535                                   # a grid's y and z extent
BWD_TILE = 64                                        # kT of csrc/ssd_scan_bwd.cu
BWD_PASS_ELEMS = 4 * 256                             # its kPassElems


def ssd_scan_ref(x, a, B, C, *, initial_state=None, norm_weights=None,
                 initial_norm_state=None):
    """Plain PyTorch version: the sequential recurrence, one step at a time
    (``repro/models/ssm.py:133`` ``ssd_scan_ref``), with state in and out.

    x: [b,T,H,P]; a: [b,T,H] log decays; B/C: [b,T,G,N], G groups dividing
    H (head h reads group h // (H // G), as ``repeat_interleave`` expands
    them); initial_state: [b,H,N,P] or None (zeros). Returns (y [b,T,H,P] in x's
    dtype, final_state [b,H,N,P] fp32). With ``norm_weights`` w [b,T,H] it
    also runs the normalizer chain Sn_t = exp(a_t) Sn_{t-1} + w_t B_t,
    n_t = C_t . Sn_t (from ``initial_norm_state`` [b,H,N] or zeros) and
    returns (y, n [b,T,H] fp32, final_state, final_norm_state [b,H,N]).
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    rep = H // B.shape[2]
    xf, af = x.float(), a.float()
    Bf, Cf = (t.float().repeat_interleave(rep, dim=2) for t in (B, C))
    S = (torch.zeros(b, H, N, P, dtype=F32, device=x.device)
         if initial_state is None else initial_state.float())
    norm = norm_weights is not None
    if norm:
        wf = norm_weights.float()
        Sn = (torch.zeros(b, H, N, dtype=F32, device=x.device)
              if initial_norm_state is None else initial_norm_state.float())
    ys, ns = [], []
    for t in range(T):
        e = torch.exp(af[:, t])                                   # [b,H]
        S = e[:, :, None, None] * S + Bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], S))
        if norm:
            Sn = e[:, :, None] * Sn + Bf[:, t] * wf[:, t, :, None]
            ns.append((Cf[:, t] * Sn).sum(-1))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if not norm:
        return y, S
    return y, torch.stack(ns, dim=1), S, Sn


def path(N: int, P: int, norm: bool) -> str:
    """The kernels a call on the card runs, by shape and arguments alone:
    "chunks" (the chunk-parallel path) where one block holds a chunk's
    whole [N, P] state and there is no normalizer, else "walk" (the
    ordered walk over the chunks)."""
    return ("chunks" if not norm and N <= SMALL_STATE and P <= SMALL_STATE
            else "walk")


def _check(x, a, B, C, initial_state, norm_weights, initial_norm_state):
    b, T, H, P = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    G, N = B.shape[2:] if B.dim() == 4 else (0, 0)
    want = {"x": (x, x.dtype, (b, T, H, P)), "a": (a, F32, (b, T, H)),
            "B": (B, x.dtype, (b, T, G, N)), "C": (C, x.dtype, (b, T, G, N)),
            "initial_state": (initial_state, F32, (b, H, N, P)),
            "norm_weights": (norm_weights, F32, (b, T, H)),
            "initial_norm_state": (initial_norm_state, F32, (b, H, N))}
    if x.dtype not in _DTYPES or x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} {x.dtype}; takes a "
                         "non-empty 4-d float32 or bfloat16 tensor")
    if N not in _STATE_SIZES:
        raise ValueError(f"ssd_scan: state size N={N} not in {_STATE_SIZES}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: B has {G} groups for {H} heads; takes "
                         "a group count that divides the heads")
    if initial_norm_state is not None and norm_weights is None:
        raise ValueError("ssd_scan: initial_norm_state without norm_weights")
    for name, (t, dtype, shape) in want.items():
        if t is None:
            continue
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; takes a contiguous {shape} "
                             f"{dtype} on {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _refused(name: str):
    """What ``build.check`` raises for a C entry's cudaErrorInvalidValue."""
    return RuntimeError(f"{name}: CUDA error 1 (invalid argument)")


def fwd_workspace_floats(route: str, b, T, H, G, N, P) -> int:
    """The fp32 workspace of a forward call on ``route``, as the C entry
    takes it; raises where the entry refuses the shape (``ssd_scan_fwd``:
    P / 32 or T / 64 blocks past a grid's extent; ``ssd_scan_chunks_fwd``:
    N not a multiple of 8, N or P past 64, b * (G + H) rows past it)."""
    chunks = -(-T // CHUNK)
    if min(b, T, H, G, P) <= 0 or H % G:
        raise _refused("ssd_scan")
    if route == "chunks":
        if (N <= 0 or N % SUM_BLOCK or N > SMALL_STATE or P > SMALL_STATE
                or b * (G + H) >= GRID_LIMIT):
            raise _refused("ssd_scan")
        # per (batch*head, chunk) dS, then S_prev, [N, P]; per (batch*group,
        # chunk) C . B^T [CHUNK, CHUNK]; per (batch*head, chunk) exp(a_tot)
        return b * chunks * (H * N * P + G * CHUNK * CHUNK + H)
    if -(-P // WALK_TILE) >= GRID_LIMIT or chunks >= GRID_LIMIT:
        raise _refused("ssd_scan")
    # per (batch*head, chunk): M [CHUNK, CHUNK] and two [CHUNK] decays
    return b * H * chunks * CHUNK * (CHUNK + 2)


def bwd_workspace_floats(b, T, H, G, N, Pe) -> int:
    """``ssd_scan_bwd_workspace``'s floats (``csrc/ssd_scan_bwd.cu``
    ``work_sizes``) for these sizes; raises where the C entry refuses them
    (``valid``: N a multiple of 4, 2 * b * H and the chunks within a
    grid's extent, the state's tiles within an int)."""
    L = CHUNK                                      # kL
    nc, ntn, ntp = -(-T // L), -(-N // BWD_TILE), -(-Pe // BWD_TILE)
    if (min(b, T, H, G, N, Pe) <= 0 or H % G or N % 4
            or 2 * b * H > GRID_LIMIT or nc > GRID_LIMIT
            or ntn * ntp > 2**31 - 1):
        raise _refused("ssd_scan_bwd_workspace")
    round4 = lambda n: -(-n // 4) * 4
    bhc = b * H * nc
    sp = round4(bhc * N * Pe)
    return (round4(bhc * (L * L + 4 * L)) + round4(b * G * nc * L * L)
            + round4(bhc * L * L) + 2 * sp + round4(bhc * -(-N * Pe // BWD_PASS_ELEMS))
            + round4(bhc * 2 * ntn * L))


def _forward(x, a, B, C, **kw):
    """The forward on its device: ``ssd_scan_ref`` on a CPU tensor, the
    kernels ``path`` picks on a CUDA tensor (counted once), their outputs
    and workspace alone on a ``meta`` tensor (its work recorded)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, a, B, C, **kw)
    _check(x, a, B, C, **kw)
    norm = kw["norm_weights"] is not None
    out = _launch(path(B.shape[-1], x.shape[-1], norm), x, a, B, C, **kw)
    if x.device.type == "meta":
        work.FLOPS["ssd_scan"] += work.ssd_scan(*x.shape[:3], *B.shape[2:],
                                              x.shape[3], norm).flops
    else:
        build.LAUNCHES["ssd_scan"] += 1
    return out


def ssd_scan(x, a, B, C, *, initial_state=None, norm_weights=None,
             initial_norm_state=None):
    """Arguments and results as ``ssd_scan_ref``; any T. On a CUDA tensor
    one call computes y, the final state and, with ``norm_weights``, the
    normalizer chain, on the kernels ``path`` picks. Differentiable in x,
    a, B, C and ``norm_weights`` (``SsdScan``)."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    kw = dict(initial_state=initial_state, norm_weights=norm_weights,
              initial_norm_state=initial_norm_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, B, C, norm_weights)):
        for name in ("initial_state", "initial_norm_state"):
            if kw[name] is not None and kw[name].requires_grad:
                raise ValueError(f"ssd_scan: {name} requires grad; no path "
                                 "differentiates it and the backward does "
                                 "not")
        return SsdScan.apply(x, a, B, C, initial_state, norm_weights,
                             initial_norm_state)
    return _forward(x, a, B, C, **kw)


class SsdScan(torch.autograd.Function):
    """The forward (``_forward``) and ``ssd_scan_bwd``. A result the caller
    does not use comes back as a gradient of None, taken as zeros."""

    @staticmethod
    def forward(ctx, x, a, B, C, initial_state, norm_weights,
                initial_norm_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a, B, C, initial_state, norm_weights,
                              initial_norm_state)
        return _forward(x, a, B, C, initial_state=initial_state,
                        norm_weights=norm_weights,
                        initial_norm_state=initial_norm_state)

    @staticmethod
    def backward(ctx, *grads):
        x, a, B, C, s0, w, sn0 = ctx.saved_tensors
        if w is None:
            (dy, d_state), dn, d_norm_state = grads, None, None
        else:
            dy, dn, d_state, d_norm_state = grads
        dx, da, dB, dC, dw = ssd_scan_bwd(
            x, a, B, C, dy, initial_state=s0, norm_weights=w,
            initial_norm_state=sn0, dn=dn, d_state=d_state,
            d_norm_state=d_norm_state)
        return (dx.to(x.dtype), da.to(a.dtype), dB.to(B.dtype),
                dC.to(C.dtype), None, None if w is None else dw.to(w.dtype),
                None)


def ssd_scan_bwd_ref(x, a, B, C, dy, *, initial_state=None,
                     norm_weights=None, initial_norm_state=None, dn=None,
                     d_state=None, d_norm_state=None):
    """Plain backward in fp32, the explicit formulas that
    ``csrc/ssd_scan_bwd.cu`` computes in chunks. With G_t the gradient of
    S_t (its own y_t's and every later step's), G_t = C_t dy_t^T +
    exp(a_{t+1}) G_{t+1} from G at T = ``d_state`` (or zeros):

        dx_t = G_t^T B_t, dB_t = G_t x_t, dC_t = S_t dy_t,
        da_t = exp(a_t) <S_{t-1}, G_t>;

    the normalizer chain likewise with its one column (input w, output n,
    gradients ``dn`` and ``d_norm_state``): dw_t = Gn_t . B_t, and its
    terms added to dB, dC and da. dB and dC are summed over each group's
    heads. The states are recomputed ``CHUNK`` steps at a time from the
    chunks' first states. A gradient given as None is zeros. Returns (dx,
    da, dB, dC, dw) in fp32; dw is None without ``norm_weights``."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    rep = H // G
    dev = x.device
    xf, af = x.float(), a.float()
    Bf, Cf = (t.float().repeat_interleave(rep, dim=2) for t in (B, C))
    dyf = torch.zeros_like(xf) if dy is None else dy.float()
    norm = norm_weights is not None

    def state(t, shape):
        return (torch.zeros(shape, dtype=F32, device=dev) if t is None
                else t.float())

    if norm:
        wf = norm_weights.float()
        dnf = (torch.zeros(b, T, H, dtype=F32, device=dev) if dn is None
               else dn.float())

    def advance(S, Sn, t):                  # the states after step t
        e = torch.exp(af[:, t])
        S = e[..., None, None] * S + Bf[:, t, :, :, None] * xf[:, t, :, None, :]
        if norm:
            Sn = e[..., None] * Sn + Bf[:, t] * wf[:, t, :, None]
        return S, Sn

    S = state(initial_state, (b, H, N, P))
    Sn = state(initial_norm_state, (b, H, N)) if norm else None
    starts = list(range(0, T, CHUNK))
    firsts = []
    for t0 in starts:                       # each chunk's first states
        firsts.append((S, Sn))
        for t in range(t0, min(t0 + CHUNK, T)):
            S, Sn = advance(S, Sn, t)
    g = state(d_state, (b, H, N, P))        # exp(a_{t+1}) G_{t+1}
    gn = state(d_norm_state, (b, H, N)) if norm else None
    dx = torch.empty(b, T, H, P, dtype=F32, device=dev)
    da = torch.empty(b, T, H, dtype=F32, device=dev)
    dBh = torch.empty(b, T, H, N, dtype=F32, device=dev)
    dCh = torch.empty(b, T, H, N, dtype=F32, device=dev)
    dw = torch.empty(b, T, H, dtype=F32, device=dev) if norm else None
    for t0, (S, Sn) in zip(reversed(starts), reversed(firsts)):
        t1 = min(t0 + CHUNK, T)
        Ss, Sns = [S], [Sn]                 # states before steps t0..t1-1, then after
        for t in range(t0, t1):
            S, Sn = advance(S, Sn, t)
            Ss.append(S)
            Sns.append(Sn)
        for t in reversed(range(t0, t1)):
            e = torch.exp(af[:, t])
            Gt = g + Cf[:, t, :, :, None] * dyf[:, t, :, None, :]
            dx[:, t] = torch.einsum("bhnp,bhn->bhp", Gt, Bf[:, t])
            dBh[:, t] = torch.einsum("bhnp,bhp->bhn", Gt, xf[:, t])
            dCh[:, t] = torch.einsum("bhnp,bhp->bhn", Ss[t - t0 + 1], dyf[:, t])
            da[:, t] = e * (Ss[t - t0] * Gt).sum(dim=(-2, -1))
            g = e[..., None, None] * Gt
            if norm:
                Gn = gn + Cf[:, t] * dnf[:, t, :, None]
                dw[:, t] = (Gn * Bf[:, t]).sum(-1)
                dBh[:, t] += Gn * wf[:, t, :, None]
                dCh[:, t] += Sns[t - t0 + 1] * dnf[:, t, :, None]
                da[:, t] += e * (Sns[t - t0] * Gn).sum(-1)
                gn = e[..., None] * Gn
    dB = dBh.reshape(b, T, G, rep, N).sum(dim=3)
    dC = dCh.reshape(b, T, G, rep, N).sum(dim=3)
    return dx, da, dB, dC, dw


def ssd_scan_bwd(x, a, B, C, dy, *, initial_state=None, norm_weights=None,
                 initial_norm_state=None, dn=None, d_state=None,
                 d_norm_state=None):
    """(dx, da, dB, dC, dw) of ``ssd_scan`` at its inputs, given the
    gradients of its results (None: zeros), as ``ssd_scan_bwd_ref``.

    A CPU tensor takes ``ssd_scan_bwd_ref``; a CUDA tensor the kernels of
    ``csrc/ssd_scan_bwd.cu`` (one call counted once in
    ``LAUNCHES["ssd_scan_bwd"]``), fp32 only: any other dtype raises before
    a launch. The normalizer runs as x's extra column (its input w appended
    to x, dn to dy), so dw comes back as that column of dx; x, dy and dx
    carry zero columns up to a multiple of 4 (``bwd_columns``,
    ``bwd_split``)."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, a, B, C, dy, initial_state=initial_state,
                                norm_weights=norm_weights,
                                initial_norm_state=initial_norm_state, dn=dn,
                                d_state=d_state, d_norm_state=d_norm_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
    _check(x, a, B, C, initial_state, norm_weights, initial_norm_state)
    if x.dtype != F32:
        raise ValueError(f"ssd_scan_bwd: x is {x.dtype}; the backward "
                         "kernels take float32 only")
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    norm = norm_weights is not None
    for name, t, shape in (("dy", dy, (b, T, H, P)), ("dn", dn, (b, T, H)),
                           ("d_state", d_state, (b, H, N, P)),
                           ("d_norm_state", d_norm_state, (b, H, N))):
        if t is not None and (t.device != x.device or t.dtype != F32
                              or tuple(t.shape) != shape):
            raise ValueError(f"ssd_scan_bwd: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; takes {shape} "
                             f"float32 on {x.device}")
    if not norm and (dn is not None or d_norm_state is not None):
        raise ValueError("ssd_scan_bwd: a normalizer gradient without "
                         "norm_weights")

    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=x.device)

    def columns(main, extra, shape, width):
        main = zeros(*shape, P) if main is None else main
        if norm and extra is None:
            extra = zeros(*shape)
        return bwd_columns(main, extra if norm else None, width)

    Pe = P + norm
    xe = columns(x, norm_weights, (b, T, H), bwd_width(Pe))
    dye = columns(dy, dn, (b, T, H), bwd_width(Pe))
    s0 = (None if initial_state is None and initial_norm_state is None
          else columns(initial_state, initial_norm_state, (b, H, N), Pe))
    dsf = (None if d_state is None and d_norm_state is None
           else columns(d_state, d_norm_state, (b, H, N), Pe))
    B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (B, C))
    ws = torch.empty(bwd_workspace_floats(b, T, H, G, N, Pe), dtype=F32,
                     device=x.device)
    dxe = torch.empty(b, T, H, bwd_width(Pe), dtype=F32, device=x.device)
    da = torch.empty(b, T, H, dtype=F32, device=x.device)
    dB = torch.empty(b, T, G, N, dtype=F32, device=x.device)
    dC = torch.empty_like(dB)
    dBh, dCh = ((dB, dC) if G == H else
                (torch.empty(b, T, H, N, dtype=F32, device=x.device)
                 for _ in range(2)))
    if x.device.type == "meta":
        work.FLOPS["ssd_scan_bwd"] += work.ssd_scan_bwd(b, T, H, G, N, P,
                                                        norm).flops
        dx, dw = bwd_split(dxe, P, norm)
        return dx, da, dB, dC, dw
    fn = build.function("ssd_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(xe.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                  dye.data_ptr(), _ptr(s0), _ptr(dsf), ws.data_ptr(),
                  dxe.data_ptr(), da.data_ptr(), dBh.data_ptr(),
                  dCh.data_ptr(), dB.data_ptr(), dC.data_ptr(), b, T, H, G, N,
                  Pe, stream)
    build.check(code, "ssd_scan_bwd")
    build.LAUNCHES["ssd_scan_bwd"] += 1
    dx, dw = bwd_split(dxe, P, norm)
    return dx, da, dB, dC, dw


def bwd_width(Pe: int) -> int:
    """Columns of x, dy and dx in ``csrc/ssd_scan_bwd.cu``: Pe rounded up to
    a multiple of 4, so that every row starts on a 16-byte boundary."""
    return -(-Pe // 4) * 4


def bwd_columns(main, extra, width):
    """``main`` [.., P] with ``extra`` [..] (or None) as column P, then zero
    columns up to ``width``: one contiguous tensor on a 16-byte boundary
    (the backward kernels' layout of x and dy, and of the states)."""
    parts = [main] + ([] if extra is None else [extra[..., None]])
    used = sum(t.shape[-1] for t in parts)
    if width > used:
        parts.append(main.new_zeros(*main.shape[:-1], width - used))
    if len(parts) > 1:
        return torch.cat(parts, dim=-1)
    main = main.contiguous()
    return main if main.data_ptr() % 16 == 0 else main.clone()


def bwd_split(dxe, P, norm):
    """(dx, dw) from the kernels' dx [.., bwd_width(Pe)]: its first P columns
    and, with the normalizer, column P (None without)."""
    dx = dxe if dxe.shape[-1] == P else dxe[..., :P]
    return dx, (dxe[..., P] if norm else None)


def bwd_occupancy(N: int, Pe: int) -> dict:
    """Per product kernel of ``csrc/ssd_scan_bwd.cu`` (``BWD_PRODUCTS``), as
    a call with state size N and Pe columns launches it on the current
    card: dynamic
    shared memory of a block, blocks per SM, registers and local (spill)
    bytes a thread."""
    out = (ctypes.c_int * (4 * len(BWD_PRODUCTS)))()
    fn = build.function("ssd_scan_bwd_occupancy", _BWD_OCC_ARGTYPES)
    build.check(fn(N, Pe, ctypes.addressof(out)), "ssd_scan_bwd_occupancy")
    keys = ("smem_bytes", "blocks_per_sm", "registers", "spill_bytes")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(BWD_PRODUCTS)}


def _launch(route, x, a, B, C, *, initial_state=None, norm_weights=None,
            initial_norm_state=None):
    """One call of the C entry of ``route`` ("chunks" or "walk") on checked
    CUDA tensors; returns as ``ssd_scan``."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    if route == "chunks" and norm_weights is not None:
        raise ValueError("ssd_scan: the chunk-parallel path has no "
                         "normalizer chain")
    y = torch.empty_like(x)
    S = torch.empty(b, H, N, P, dtype=F32, device=x.device)
    norm = norm_weights is not None
    n = torch.empty(b, T, H, dtype=F32, device=x.device) if norm else None
    Sn = torch.empty(b, H, N, dtype=F32, device=x.device) if norm else None
    ws = torch.empty(fwd_workspace_floats(route, b, T, H, G, N, P),
                     dtype=F32, device=x.device)
    if x.device.type == "meta":
        return (y, n, S, Sn) if norm else (y, S)
    # B and C are copied into shared memory 16 bytes at a time
    B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (B, C))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                _ptr(initial_state), y.data_ptr(), S.data_ptr())
        dims = (_DTYPES[x.dtype], b, T, H, G, N, P, stream)
        if route == "chunks":
            code = build.function("ssd_scan_chunks_fwd", _CHUNKS_ARGTYPES)(
                *head, ws.data_ptr(), *dims)
        else:
            code = build.function("ssd_scan_fwd", _ARGTYPES)(
                *head, _ptr(norm_weights), _ptr(initial_norm_state), _ptr(n),
                _ptr(Sn), ws.data_ptr(), *dims)
    build.check(code, "ssd_scan")
    return (y, n, S, Sn) if norm else (y, S)

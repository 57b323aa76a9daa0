"""Dense MLP (gated SwiGLU, or ungated: whisper's GELU) and the
sort-dispatch MoE: the counterpart of ``repro/models/mlp.py``. The ungated
MoE is not ported yet.

The MoE is the JAX package's capacity-bucketed sort dispatch: each token's
top-k experts are sorted by expert (a stable sort, so tokens keep their
order within an expert), the first C slots of each expert are gathered
into an [E, C, d] buffer (slots past the capacity C are dropped), pushed
through batched expert products, and combined back weighted by the
renormalised router probabilities. Where JAX scatters into the buffer and
scatter-adds the combine, the port gathers both ways, so no two writes meet
and two calls give the same bits: the buffer gathers each kept slot's
token, and each token sums its K expert rows in ascending expert order (the
order JAX's scatter-add meets them in on the CPU), rounding to x's dtype
after each add as that scatter-add does. The expert products are plain
large products outside any Pallas kernel in the JAX package, left to
``torch.bmm`` here.

The backward is JAX's autodiff of the same forward with gathers in place
of its scatter-adds, through ``autograd.Function``s that run the same code
on the CPU and the card: ``_Dispatch``'s backward sums each token's kept
slots' cotangents in ascending expert order (the order in which JAX's
transpose of the dispatch gather scatter-adds them), ``_Combine``'s hands
each kept slot its token's cotangent times the slot's weight (one owner
per slot), and ``_BmmF32`` takes the fp32-out product's backward in fp32,
as JAX transposes ``preferred_element_type=F32``. No backward adds with
atomics or into a shared row, so a step repeats its bits. The weights'
gradient runs on through the renormalisation, ``topk`` (a scatter into
unique indices) and the router under autograd.
"""
from __future__ import annotations

import math

import torch

from .common import F32, activation_fn, dense_init, matmul, normal_init


def init_mlp_params(generator, cfg, dtype, device, lead=()):
    """``w_up``, ``w_down`` and, for a gated MLP, ``w_gate``."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(generator, d, f, dtype, device, lead=lead),
         "w_down": dense_init(generator, f, d, dtype, device, lead=lead)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, d, f, dtype, device, lead=lead)
    return p


def mlp_forward(p, cfg, x):
    """Gated: ``act(x @ w_gate) * (x @ w_up)``; ungated: ``act(x @ w_up)``;
    the activation in fp32, cast back to x's dtype; then ``@ w_down``."""
    act = activation_fn(cfg.activation)
    up = matmul(x, p["w_up"])
    if "w_gate" in p:
        h = act(matmul(x, p["w_gate"]).float()).to(x.dtype) * up
    else:
        h = act(up.float()).to(x.dtype)
    return matmul(h, p["w_down"])


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def init_moe_params(generator, cfg, dtype, device, lead=()):
    """The router in fp32, experts ``[*lead, E, d, f]`` / ``[*lead, E, f,
    d]`` in ``dtype``: the distributions of ``repro/models/mlp.py:43-53``."""
    if not cfg.gated_mlp:
        raise NotImplementedError("the ungated MoE is not ported yet")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {
        "router": dense_init(generator, d, E, F32, device, lead=lead),
        "w_up": normal_init(generator, (*lead, E, d, f), 1 / math.sqrt(d),
                            dtype, device),
        "w_down": normal_init(generator, (*lead, E, f, d), 1 / math.sqrt(f),
                              dtype, device),
        "w_gate": normal_init(generator, (*lead, E, d, f), 1 / math.sqrt(d),
                              dtype, device),
    }


class _BmmF32(torch.autograd.Function):
    """``a @ b`` batched, bf16 operands, the fp32 accumulator as the
    result; its backward as JAX transposes ``preferred_element_type=F32``
    (``_dot_general_transpose_lhs``): the fp32 cotangent times the other
    operand upcast, the product in fp32, cast to the operand's dtype. The
    cotangent is not representable in bf16, so a bf16 product of it would
    be another result. The backward upcasts the whole weight (and the
    buffer): 738 MB for moonshot's ``w_gate`` a call, the cost that
    fp32-out products without upcasts would take away."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:       # the bf16 product writes its fp32 accumulator
            return torch.bmm(a, b, out_dtype=F32)
        return torch.bmm(a.float(), b.float())   # exact for bf16 values

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def bmm_f32(a, b):
    """``a @ b`` batched, with the fp32 accumulator as the result (JAX's
    ``preferred_element_type=F32``). On the card a bf16 product writes its
    fp32 accumulator itself (``out_dtype``), so the forward upcasts no
    expert weight; on the CPU the operands are upcast, exact for bf16
    values. Differentiable through ``_BmmF32``."""
    if a.dtype == F32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def _ordered_sum(rows):
    """[N, K, d] -> [N, d]: ``rows[:, 0] + rows[:, 1] + ...`` left to
    right, rounding to the rows' dtype after each add (JAX's scatter-add
    of K rows into one)."""
    out = rows[:, 0]
    for i in range(1, rows.shape[1]):
        out = out + rows[:, i]
    return out


def _with_zero_row(t):
    """[M, d] -> [M + 1, d]: row M is zeros, the row that a dropped or an
    unfilled slot reads."""
    return torch.cat([t, t.new_zeros(1, t.shape[-1])])


class _Dispatch(torch.autograd.Function):
    """``buf[e, c] = xf[token[e * C + c]]`` where ``filled[e, c]``, else 0.
    Backward: token n's cotangent is the sum of the cotangents of its
    slots ``slots[n]`` (its K choices in ascending expert order, ``E * C``
    for a dropped one, which adds nothing), added left to right in x's
    dtype: one owner per output row, no atomics."""

    @staticmethod
    def forward(ctx, xf, token, filled, slots):
        ctx.save_for_backward(slots)
        E, C = filled.shape
        buf = xf.index_select(0, token).view(E, C, xf.shape[-1])
        return torch.where(filled[..., None], buf, 0)

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        rows = _with_zero_row(g.reshape(-1, g.shape[-1]))[slots]
        return _ordered_sum(rows), None, None, None


class _Permute(torch.autograd.Function):
    """``w[n, order[n, j]]`` for a permutation ``order`` of each row; its
    backward gathers through the inverse permutation (no scatter)."""

    @staticmethod
    def forward(ctx, w, order):
        ctx.save_for_backward(order)
        return torch.gather(w, 1, order)

    @staticmethod
    def backward(ctx, g):
        order, = ctx.saved_tensors
        return torch.gather(g, 1, torch.argsort(order, dim=1)), None


class _Combine(torch.autograd.Function):
    """``out[n] = sum_j y[slots[n, j]] * w[n, j]`` over token n's K choices
    in ascending expert order (``slots`` and ``w`` in that order; ``E * C``
    for a dropped choice, which adds 0), left to right in y's dtype.
    Backward: each kept slot receives its owner's cotangent times its
    weight, a gather through ``owner`` (the sorted choice n * K + j that
    holds each slot, N * K for none); each weight the sum over d of its
    token's cotangent times its slot's row, the product rounded to y's
    dtype first, as autograd takes it."""

    @staticmethod
    def forward(ctx, y_buf, w, slots):
        E, C, d = ctx.buf_shape = y_buf.shape
        y = _with_zero_row(y_buf.reshape(E * C, d))
        ctx.save_for_backward(y, w, slots)
        return _ordered_sum(y[slots] * w[..., None])

    @staticmethod
    def backward(ctx, g):
        y, w, slots = ctx.saved_tensors
        (E, C, d), (N, K) = ctx.buf_shape, slots.shape
        dy = dw = None
        if ctx.needs_input_grad[0]:
            owner = torch.full((E * C + 1,), N * K, dtype=slots.dtype,
                               device=slots.device)
            owner[slots.reshape(-1)] = torch.arange(
                N * K, dtype=slots.dtype, device=slots.device)
            rows = (g[:, None, :] * w[..., None]).reshape(N * K, d)
            dy = _with_zero_row(rows)[owner[:E * C]].view(E, C, d)
        if ctx.needs_input_grad[1]:
            dw = (g[:, None, :] * y[slots]).sum(dim=-1)
        return dy, dw, None


def capacity(cfg, n_tokens: int, inference: bool) -> int:
    """Slots per expert: every token (``inference``, drop-free) or the
    capacity factor's share, Python's ``round`` (half to even) as JAX's."""
    if inference:
        return n_tokens
    C = int(max(1, round(n_tokens * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor)))
    return min(C, n_tokens)


def route(top_e, counts, C: int):
    """The sort dispatch's indices for top-k choices ``top_e`` [N, K] with
    ``counts`` [E] choices an expert and C slots an expert:
    - ``token`` [E * C]: the token in each slot (meaningful where filled);
    - ``filled`` [E, C]: slot c of expert e holds a token;
    - ``slots`` [N, K]: the slot ``e * C + c`` of each token's choices in
      ascending expert order, ``E * C`` for a choice dropped past C;
    - ``order`` [N, K]: each token's choices sorted by expert.
    Slot c of expert e is its c-th routed token in token order (a stable
    sort of the flattened choices by expert)."""
    N, K = top_e.shape
    E, dev = counts.shape[0], top_e.device
    flat_e = top_e.reshape(-1)                                    # [N*K]
    sort_idx = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts                     # [E]
    pos_in_e = torch.arange(N * K, device=dev) - starts[flat_e[sort_idx]]
    rank = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(N * K, device=dev))             # unsort
    pos = pos_in_e[rank]                                          # [N*K]
    slots = torch.where(pos < C, flat_e * C + pos, E * C).view(N, K)
    order = torch.argsort(top_e, dim=-1)
    slot = starts[:, None] + torch.arange(C, device=dev)[None, :]   # [E, C]
    filled = torch.arange(C, device=dev)[None, :] < counts[:, None]
    token = sort_idx[slot.clamp(max=N * K - 1).reshape(-1)] // K
    return token, filled, torch.gather(slots, 1, order), order


def moe_forward(p, cfg, x, inference: bool = False):
    """x: [B, T, d] -> (y [B, T, d], aux): ``repro/models/mlp.py:56-118``.

    ``inference`` selects drop-free capacity (C = N), which single-token
    decode needs; prefill, as JAX's, drops slots past capacity."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, d)

    logits = matmul(xf, p["router"].to(xf.dtype), out_dtype=F32)   # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                   # [N, K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    flat_e = top_e.reshape(-1)                                    # [N*K]
    counts = torch.bincount(flat_e, minlength=E)                  # [E]
    aux = E * torch.sum(probs.mean(dim=0) * (counts.float() / (N * K)))
    aux = aux * cfg.router_aux_coef

    C = capacity(cfg, N, inference)
    token, filled, slots, order = route(top_e, counts, C)
    buf = _Dispatch.apply(xf, token, filled, slots)

    act = activation_fn(cfg.activation)
    up = torch.bmm(buf, p["w_up"])
    h = act(bmm_f32(buf, p["w_gate"])).to(x.dtype) * up
    y_buf = torch.bmm(h, p["w_down"])                             # [E, C, d]

    # combine: token n's rows in ascending expert order, each weighted in
    # x's dtype; a dropped slot contributes 0
    out = _Combine.apply(y_buf, _Permute.apply(top_p.to(x.dtype), order),
                         slots)
    return out.reshape(B, T, d), aux

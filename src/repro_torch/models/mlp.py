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


def bmm_f32(a, b):
    """``a @ b`` batched, with the fp32 accumulator as the result (JAX's
    ``preferred_element_type=F32``). On the card a bf16 product writes its
    fp32 accumulator itself (``out_dtype``), so no expert weight is upcast;
    on the CPU the operands are upcast, exact for bf16 values."""
    if a.dtype == F32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.float(), b.float())


def capacity(cfg, n_tokens: int, inference: bool) -> int:
    """Slots per expert: every token (``inference``, drop-free) or the
    capacity factor's share, Python's ``round`` (half to even) as JAX's."""
    if inference:
        return n_tokens
    C = int(max(1, round(n_tokens * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor)))
    return min(C, n_tokens)


def moe_forward(p, cfg, x, inference: bool = False):
    """x: [B, T, d] -> (y [B, T, d], aux): ``repro/models/mlp.py:56-118``.

    ``inference`` selects drop-free capacity (C = N), which single-token
    decode needs; prefill, as JAX's, drops slots past capacity."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, d)
    dev = x.device

    logits = matmul(xf, p["router"].to(xf.dtype), out_dtype=F32)   # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                   # [N, K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    flat_e = top_e.reshape(-1)                                    # [N*K]
    counts = torch.bincount(flat_e, minlength=E)                  # [E]
    aux = E * torch.sum(probs.mean(dim=0) * (counts.float() / (N * K)))
    aux = aux * cfg.router_aux_coef

    # sort-based dispatch: slot j of the sorted order is the pos_in_e-th
    # routed token of expert sorted_e[j]; the first C of each expert stay
    C = capacity(cfg, N, inference)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts                     # [E]
    pos_in_e = torch.arange(N * K, device=dev) - starts[sorted_e]

    # buf[e, c] = x of the token in expert e's c-th slot, 0 past its count
    slot = starts[:, None] + torch.arange(C, device=dev)[None, :]   # [E, C]
    filled = torch.arange(C, device=dev)[None, :] < counts[:, None]
    token = sort_idx[slot.clamp(max=N * K - 1).reshape(-1)] // K
    buf = xf.index_select(0, token).view(E, C, d)
    buf = torch.where(filled[..., None], buf, 0)

    act = activation_fn(cfg.activation)
    up = torch.bmm(buf, p["w_up"])
    h = act(bmm_f32(buf, p["w_gate"])).to(x.dtype) * up
    y_buf = torch.bmm(h, p["w_down"])                             # [E, C, d]

    # combine: row (n, k) is expert top_e[n, k]'s output for token n,
    # weighted in x's dtype; a dropped slot contributes 0
    rank = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(N * K, device=dev))             # unsort
    pos = pos_in_e[rank]                                          # [N*K]
    keep = pos < C
    rows = y_buf.view(E * C, d).index_select(
        0, flat_e * C + pos.clamp(max=C - 1))
    rows = torch.where(keep[:, None], rows, 0)
    rows = (rows * top_p.reshape(-1).to(x.dtype)[:, None]).view(N, K, d)
    order = torch.argsort(top_e, dim=-1)                          # by expert
    rows = torch.gather(rows, 1, order[..., None].expand(N, K, d))
    out = rows[:, 0]
    for i in range(1, K):
        out = out + rows[:, i]
    return out.reshape(B, T, d), aux

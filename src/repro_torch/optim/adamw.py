"""AdamW on param trees (counterpart of ``repro/optim/adamw.py``).

The state is ``{"m", "v", "count"}``: moments with the params' tree and
shapes, in ``dtype`` (fp32 by default; ``cfg.opt_state_dtype``, which
nemotron sets to bf16), and the step count, an int32 scalar tensor. The arithmetic is the JAX package's, step for step:
clip by the global norm, moments in fp32, bias correction from ``count``,
decoupled weight decay on every leaf with ``ndim >= 2``. On the stacked
param tree that includes the stacked gains (``ln1``, ``ln2``, ``q_norm``,
``k_norm``: ``[L, d]``) and leaves out ``final_norm`` (``[d]``), as the
reference does.

Where JAX returns new trees, the update writes params and moments in place
(under ``torch.no_grad``), so views taken of the stacked leaves keep
pointing at the updated values and no second copy of the params is made;
the returned trees are the ones passed in.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dtype_of, tree_leaves, tree_map

F32 = torch.float32


def adamw_init(params, dtype: str = "float32"):
    dt = dtype_of(dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, max_grad_norm=1.0):
    """Returns (params, opt_state, grad_norm); params and moments are
    updated in place."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    count = opt_state["count"] + 1
    c1 = 1.0 - b1 ** count.to(F32)
    c2 = 1.0 - b2 ** count.to(F32)

    def upd(p, g, m, v):
        g32 = g.to(F32)
        m32 = m.to(F32) * b1 + g32 * (1 - b1)
        v32 = v.to(F32) * b2 + torch.square(g32) * (1 - b2)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            step = step + weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * step)
        m.copy_(m32)
        v.copy_(v32)

    # leaves matched by key path (not by flat order: trees built elsewhere
    # may order their dict keys differently)
    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, gnorm

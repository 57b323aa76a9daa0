"""The sweep's member step in the port (counterpart of
``repro/launch/sweep.py:43-47`` and its config at ``:66-68``).

A member is the reduced config of an arch with ``n_layers=2``, fp32 params
and no remat, trained by ``member_step(params, opt, batch, lr)``:
``forward_loss`` -> gradients of every param leaf -> ``adamw_update``. The
``n_layers=2`` does not shorten the model: ``reduced()`` fixes
``block_pattern`` at the reduced layer count (4 for qwen3) and the pattern
decides the stages, in the JAX package and in its copy here alike.

The gradients come from autograd through the port's kernels: the flash
attention and RMSNorm ``autograd.Function``s launch the hand-written
backward kernels on the card. The sweep's command line (the task array,
preposition and supervisor) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.models import forward_loss
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw_update


def member_config(arch: str = "qwen3-0.6b"):
    """The sweep member's config: ``repro/launch/sweep.py:66-68``."""
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2,
                               param_dtype="float32", remat="none")


def loss_and_grads(params, cfg, batch):
    """(loss, grads): ``forward_loss`` and its gradient with respect to every
    param leaf, in the params' tree. It differentiates detached aliases of
    the leaves (the same storage), so the caller's params stay as they were:
    none requires grad, and serving them afterwards records no graph."""
    alias = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = forward_loss(alias, cfg, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(alias)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def to_batch(batch, device):
    """numpy batch (``SyntheticLM``) -> int64 tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}


def build_member_step(cfg, device="cuda"):
    """``member_step(params, opt, batch, lr) -> (params, opt, loss)`` on
    ``device`` (the card unless the caller asks for the CPU). ``batch`` is
    numpy or tensors; params and moments are updated in place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("member_step: device 'cuda' asked for but no CUDA "
                           "card is available (pass device='cpu')")

    def member_step(params, opt, batch, lr):
        loss, grads = loss_and_grads(params, cfg, to_batch(batch, device))
        params, opt, _ = adamw_update(grads, opt, params, lr=lr)
        return params, opt, loss

    return member_step

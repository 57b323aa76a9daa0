"""The train step of the port (counterpart of ``repro/train/step.py``).

``train_step(params, opt_state, batch, step)`` runs the reference's step on
one device: the batch is cut into ``cfg.microbatches`` microbatches, each
gives ``forward_loss`` and its gradients, the gradients are summed in fp32
and divided by their count, optionally quantised to int8 and back
(``grad_compress="int8"``, ``optim.compress``), and ``adamw_update`` applies
them at ``cosine_warmup(step)``. The gradients come from autograd through
the kernels' ``autograd.Function``s, on detached aliases of the params
(``loss_and_grads``), so the caller's params never require grad.

Differences by design, beside the reference:
- No mesh, shardings or ``donate``: ``parallel/`` is not ported, and the
  port trains on one device. Where JAX donates the params and moments to
  the step, the port updates them in place (``adamw_update``), after every
  gradient is computed; the step returns the trees it was given.
- The microbatches run in a Python loop where JAX scans them.
- ``shaped_batch`` gives tensors on the ``meta`` device where JAX gives
  ``ShapeDtypeStruct``s, and its ids are ``torch.long`` (see there).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import forward_loss, init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import (adamw_init, adamw_update, compress_residual,
                               cosine_warmup)

F32 = torch.float32


def shaped_batch(cfg, shape):
    """A batch of one cell as tensors on the ``meta`` device (shapes and
    dtypes, no storage), as ``repro/train/step.py:30-48``: tokens and labels
    [B, T]; whisper's ``frames`` [B, T, d] for a train shape and
    [B, enc_len, d] otherwise; qwen2-vl's M-RoPE ``pos3`` [3, B, T],
    ``patch_embeds`` [B, npatch, d] and ``patch_pos`` [B, npatch] with
    npatch = max(8, min(1024, T // 8)). Embeddings are bf16, as JAX's;
    the ids are ``torch.long`` where JAX's are int32, because the port
    indexes with them (``F.embedding``, ``index_put``, ``gather``) and
    ``to_batch`` gives every id tensor that dtype."""
    B, T = shape.global_batch, shape.seq_len
    ids = lambda *s: torch.empty(s, dtype=torch.long, device="meta")
    emb = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    batch = {"tokens": ids(B, T), "labels": ids(B, T)}
    if cfg.enc_dec:
        batch["frames"] = emb(B, T if shape.kind == "train" else cfg.enc_len,
                              cfg.d_model)
    if cfg.mrope_sections:
        npatch = max(8, min(1024, T // 8))
        batch["pos3"] = ids(3, B, T)
        batch["patch_embeds"] = emb(B, npatch, cfg.d_model)
        batch["patch_pos"] = ids(B, npatch)
    return batch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is visible (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for but no CUDA "
                           "card is available (pass device='cpu')")
    return dev


def to_batch(batch, device):
    """numpy (or tensor) batch -> tensors on ``device``: ids (tokens,
    labels, ``pos3``, ``patch_pos``) as int64, embeddings (``frames``,
    ``patch_embeds``) in their own floating dtype."""
    def leaf(v):
        t = torch.as_tensor(v, device=device)
        return t if t.is_floating_point() else t.long()
    return {k: leaf(v) for k, v in batch.items()}


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


def _microbatch_stack(batch, k: int):
    """Reshape every leaf [.., B, ..] -> [k, .., B//k, ..] (batch dim 0,
    except pos3 where it is 1), so microbatch i is ``leaf[i]``."""
    def rs(name, x):
        axis = 1 if name == "pos3" else 0
        B = x.shape[axis]
        assert B % k == 0, (name, B, k)
        x = x.reshape(x.shape[:axis] + (k, B // k) + x.shape[axis + 1:])
        return torch.movedim(x, axis, 0)
    return {name: rs(name, x) for name, x in batch.items()}


def microbatch_grads(params, cfg, batch, k: int):
    """(loss, grads) of ``batch`` (int64 tensors on the params' device) cut
    into ``k`` microbatches: the mean of the microbatches' losses and of
    their gradients, summed in fp32 (the grads come out fp32, as the
    reference's accumulator)."""
    mbs = _microbatch_stack(batch, k)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                           device=p.device), params)
    loss_sum = torch.zeros((), dtype=F32, device=tree_leaves(params)[0].device)
    for i in range(k):
        loss, g = loss_and_grads(params, cfg,
                                 {name: x[i] for name, x in mbs.items()})
        tree_map(lambda acc, x: acc.add_(x.to(F32)), grads, g)
        loss_sum = loss_sum + loss
        del g
    tree_map(lambda acc: acc.div_(k), grads)
    return loss_sum / k, grads


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000,
                    grad_compress: Optional[str] = None, device="cuda"):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` on ``device`` (the card unless the caller asks for the CPU);
    ``batch`` is numpy or tensors, ``step`` an int; ``metrics`` holds
    ``loss``, ``lr`` and ``grad_norm``."""
    if grad_compress not in (None, "int8"):
        raise ValueError(f"grad_compress {grad_compress!r}: takes None or "
                         "'int8'")
    dev = resolve_device(device)
    k = max(1, cfg.microbatches)

    def train_step(params, opt_state, batch, step):
        loss, grads = microbatch_grads(params, cfg, to_batch(batch, dev), k)
        if grad_compress == "int8":
            grads = tree_map(lambda x: compress_residual(x)[0], grads)
        lr = cosine_warmup(step, peak_lr=peak_lr, warmup_steps=warmup,
                           total_steps=total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                lr=lr)
        return params, opt_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    return train_step


def init_train_state(cfg, seed: int = 0, device="cuda"):
    """(params, opt_state): ``init_params`` from a generator seeded with
    ``seed`` on ``device``, and AdamW moments in ``cfg.opt_state_dtype``."""
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
    return params, adamw_init(params, cfg.opt_state_dtype)

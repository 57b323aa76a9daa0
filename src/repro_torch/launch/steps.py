"""Step builder of the port: one entry point for every (arch x shape) cell
(counterpart of ``repro/launch/steps.py``).

``build_step(cfg, shape, device)`` returns a :class:`StepSpec`, the cell's
program and its arguments, for whichever program the shape's kind needs:

  train    train_step(params, opt, batch, step)   ``make_train_step``
  prefill  prefill_step(params, batch)            ``prefill``
  decode   serve_step(params, token, cache, cache_len)
                                                  ``decode_step``: one new
                                                  token against a
                                                  seq_len-sized KV cache

``fn`` runs on ``device`` (the card unless the caller asks for the CPU or
``meta``). ``args`` are abstract, as JAX's ``ShapeDtypeStruct``s are:
tensors on ``meta``, shapes and dtypes with no storage; the dry-run
evaluates ``fn`` on them there, and ``real_args`` gives them storage on a
device (random params from a seed, as ``init_params`` draws them). One
card has no mesh: where JAX's spec carries in- and out-shardings, this
one carries none. ``donate`` names the arguments the program updates in
place (the params and moments of a train step, the cache of a decode
step), as JAX donates them.

Beside JAX's arguments, by design: ids are ``torch.long`` where JAX's are
int32 (``train.step.shaped_batch``); the train step's ``step`` and
decode's ``cache_len`` are int32 scalars on the host, where the program
reads their value (the schedule's step; the cache slot the new token goes
to), so they stay there whatever ``device`` is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw_init
from repro_torch.train.step import make_train_step, shaped_batch

META = torch.device("meta")
F32 = torch.float32


@dataclass
class StepSpec:
    name: str                       # train_step | prefill_step | serve_step
    fn: Callable
    args: Tuple[Any, ...]           # trees of tensors on meta (+ host scalars)
    donate: Tuple[int, ...] = ()    # arguments the program updates in place


def host_scalar(value: int = 0):
    """An int32 scalar on the host (the train step's ``step``, decode's
    ``cache_len``)."""
    return torch.tensor(value, dtype=torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every model input of this cell: tensors on ``meta`` (the batch of a
    train or prefill cell; a decode cell's token [B], its cache from
    ``init_cache`` and ``cache_len``, a host int32 scalar at seq_len - 1:
    the cache is full)."""
    if shape.kind in ("train", "prefill"):
        return shaped_batch(cfg, shape)
    B = shape.global_batch
    return {"token": torch.empty(B, dtype=torch.long, device=META),
            "cache": init_cache(cfg, B, shape.seq_len, device=META),
            "cache_len": host_scalar(shape.seq_len - 1)}


def build_step(cfg: ArchConfig, shape: ShapeConfig, device="cuda") -> StepSpec:
    """The cell's :class:`StepSpec`, its program on ``device`` and its
    arguments on ``meta``; raises ``ValueError`` for a cell the skip rule
    leaves out."""
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape.name}: {why}")
    build = {"train": _build_train, "prefill": _build_prefill,
             "decode": _build_decode}[shape.kind]
    return build(cfg, shape, torch.device(device))


def real_args(spec: StepSpec, cfg: ArchConfig, device, seed: int = 0):
    """``spec.args`` with storage on ``device``: params from ``init_params``
    with a generator seeded by ``seed``, AdamW moments and caches zeros (as
    ``adamw_init`` and ``init_cache`` make them), ids (tokens, labels)
    drawn below the vocabulary, ``pos3`` the positions on all three axes,
    ``patch_pos`` evenly spaced, embeddings drawn N(0, 1); host scalars as
    they are."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def leaf(name, t, T=0):
        if t.device.type != "meta":
            return t
        if t.is_floating_point():
            out = torch.empty(t.shape, dtype=F32, device=dev)
            return out.normal_(generator=gen).to(t.dtype)
        if name == "pos3":
            T = t.shape[-1]
            return torch.arange(T, device=dev).expand(t.shape).clone()
        if name == "patch_pos":
            P = t.shape[-1]
            return (torch.arange(P, device=dev) * max(1, T // P)).expand(
                t.shape).clone()
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=dev, dtype=t.dtype)

    params = init_params(cfg, gen, device=dev)
    out = [params]
    for arg in spec.args[1:]:
        if isinstance(arg, dict) and set(arg) == {"m", "v", "count"}:
            out.append(adamw_init(params, cfg.opt_state_dtype))
        elif isinstance(arg, dict) and "stages" in arg:
            out.append(tree_map(lambda t: torch.zeros(
                t.shape, dtype=t.dtype, device=dev), arg))
        elif isinstance(arg, dict):
            T = arg["tokens"].shape[-1]
            out.append({k: leaf(k, v, T) for k, v in arg.items()})
        else:
            out.append(leaf("", arg))
    return tuple(out)


# --------------------------------------------------------------------------
def _build_train(cfg, shape, device) -> StepSpec:
    fn = make_train_step(cfg, device=device)
    params = init_params(cfg, device=META)
    opt = adamw_init(params, cfg.opt_state_dtype)
    args = (params, opt, shaped_batch(cfg, shape), host_scalar(0))
    return StepSpec("train_step", fn, args, donate=(0, 1))


def _build_prefill(cfg, shape, device) -> StepSpec:
    def prefill_step(params, batch):
        kwargs = {k: v for k, v in batch.items() if k != "tokens"}
        return prefill(params, cfg, batch["tokens"], **kwargs)

    batch = {k: v for k, v in shaped_batch(cfg, shape).items()
             if k != "labels"}
    return StepSpec("prefill_step", prefill_step,
                    (init_params(cfg, device=META), batch))


def _build_decode(cfg, shape, device) -> StepSpec:
    def serve_step(params, token, cache, cache_len):
        return decode_step(params, cfg, token, cache, cache_len)

    spec = input_specs(cfg, shape)
    args = (init_params(cfg, device=META), spec["token"], spec["cache"],
            spec["cache_len"])
    return StepSpec("serve_step", serve_step, args, donate=(2,))

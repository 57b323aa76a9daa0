"""Carry a param (or cache) tree between the JAX package and the port.

A JAX tree arrives as nested dicts / lists / tuples of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``); the port's tree has
the same key paths with torch tensors at the leaves. Stages keep their
stacked leading layer axis on both sides: the port indexes the stack where
JAX scans it, so nothing is un-stacked.

bf16 arrives as ``ml_dtypes.bfloat16``, which torch cannot read; it crosses
as its raw 16 bits (a ``uint16``-sized view, as ``repro/ckpt/checkpoint.py``
stores it), so values are bit-exact both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def _leaf_to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _bfloat16_numpy_dtype():
    try:
        return np.dtype("bfloat16")
    except TypeError:
        raise TypeError("a bf16 tensor needs numpy's bfloat16 type, which "
                        "ml_dtypes registers when it (or jax) is imported")


def _leaf_to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bfloat16_numpy_dtype())
    return t.numpy()


def to_torch(tree, device="cuda"):
    """numpy tree (JAX layout) -> tensor tree on ``device`` (the card unless
    the caller asks for the CPU)."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def to_numpy(tree):
    """Tensor tree -> numpy tree with the same key paths and dtypes."""
    return tree_map(_leaf_to_numpy, tree)

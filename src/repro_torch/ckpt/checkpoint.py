"""Checkpoints of the port (counterpart of ``repro/ckpt/checkpoint.py``),
in the reference's on-disk layout, so each package restores the other's:

    <dir>/step_<N>/
        manifest.msgpack   step, meta, treedef, {leaf key: shape, dtype}
        arrays.npz         the leaves; key = tree path, "/" written as \\x01

A leaf's key is its path in the tree, dict keys and list indices joined by
"/" (``params/stages/0/attn/wq``), as ``jax.tree_util``'s paths give it;
dict keys are visited in sorted order, as JAX flattens them. bf16 is
stored as its ``uint16`` view under the dtype name ``"bfloat16"``. Saves
are atomic (written to ``.tmp``, then renamed).

Differences by design:
- The manifest is written and read by the port's own MessagePack subset
  (``ckpt/msgpack.py``): the card's machine has neither ``msgpack`` nor
  ``ml_dtypes``.
- ``treedef`` is a string of the port's own (the tree's nesting with
  ``*`` at the leaves). ``restore`` reads the structure from ``like``, not
  from it, in both packages.
- ``restore`` takes a ``device`` where the reference takes shardings.
- ``CheckpointManager.save_async`` copies every leaf to the host before its
  thread starts: the caller's next step updates the params in place, the
  hazard JAX's donation poses to the reference.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from . import msgpack

_NATIVE = {"float32", "float64", "float16", "int32", "int64", "int16",
           "int8", "uint8", "uint16", "uint32", "uint64", "bool"}


def _flatten(tree, prefix=()):
    """[(path, leaf)] in JAX's flatten order: dict keys sorted, list and
    tuple items in order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _flatten(tree[key], prefix + (str(key),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in _flatten(sub, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {key: _map_with_path(fn, sub, prefix + (str(key),))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, sub, prefix + (str(i),))
                          for i, sub in enumerate(tree))
    return fn("/".join(prefix), tree)


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_treedef(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(sub) for sub in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_host(leaf):
    """(a host copy of a tensor or array in a dtype npz stores, its dtype
    name): bf16 as its uint16 view. Always a copy, also of a CPU tensor, so
    later in-place updates of the leaf do not reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    name = str(arr.dtype)
    if name not in _NATIVE:
        raise TypeError(f"checkpoint: cannot store dtype {name}")
    return arr, name


def _from_native(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if name not in _NATIVE:
        raise TypeError(f"checkpoint: cannot read dtype {name}")
    return torch.from_numpy(np.array(arr))


def _write(ckpt_dir: str, step: int, natives, treedef: str,
           meta: Optional[dict]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", "\x01"): v for k, (v, _) in natives})
    manifest = {
        "step": step,
        "meta": meta or {},
        "treedef": treedef,
        "leaves": {k: {"shape": list(v.shape), "dtype": name}
                   for k, (v, name) in natives},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_copy(tree):
    return [(key, _to_host(leaf)) for key, leaf in _flatten(tree)]


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None):
    """Blocking atomic save of a tree of tensors (or numpy arrays)."""
    return _write(ckpt_dir, step, _host_copy(tree), _treedef(tree), meta)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device="cuda"):
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    in its ``like`` leaf's dtype, on ``device`` (the card unless the caller
    asks for the CPU). Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    with np.load(os.path.join(d, "arrays.npz")) as data:
        stored = {k.replace("\x01", "/"): k for k in data.files}

        def leaf(key, like_leaf):
            if key not in stored:
                raise KeyError(f"checkpoint missing leaf {key}")
            t = _from_native(data[stored[key]],
                             manifest["leaves"][key]["dtype"])
            return t.to(device=device, dtype=like_leaf.dtype)

        tree = _map_with_path(leaf, like)
    return tree, manifest


class CheckpointManager:
    """Async writer + retention. One background thread; ``save_async``
    returns once the tree is on the host, ``wait()`` joins (called before
    process exit / next save)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        # on the host before the thread starts: the caller updates the
        # params and moments in place next
        natives, treedef = _host_copy(tree), _treedef(tree)

        def work():
            _write(self.dir, step, natives, treedef, meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.dir)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

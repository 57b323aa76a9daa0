"""One-card dry-run of the port: does each (arch x shape) cell's program fit
one card, and what does it cost? (Counterpart of ``repro/launch/dryrun.py``.)

For every cell, ``build_step``'s program runs once on the ``meta`` device,
an abstract evaluation like ``jax.eval_shape``: every tensor has its shape
and dtype and no storage, the kernel wrappers check, allocate and count
their work as on the card (and raise where the card raises) but launch
nothing, and no plain version runs. Each record keeps the JAX record's
keys where they mean something on one card:

- ``status`` (ok | skip | fail) and ``reason``; ``program``; ``chips`` 1;
- ``params`` and ``active_params`` (the configs' analytic counts);
- ``memory.argument_bytes``: the bytes of the arguments' storages;
  ``memory.output_bytes``: of the outputs' storages, the arguments the
  program updates in place (params and moments, a decode cache) among
  them; ``memory.temp_bytes``: the most bytes live at once beyond the
  arguments, every storage the program makes counted from its creation to
  its death (``LiveBytes``); ``memory.peak_bytes`` = arguments + temps;
- ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the aten ops (the matrix products) plus the kernels' counted
  work (``kernels.work``: visible attention pairs, the scans), with the
  kernels' share apart in ``kernel_flops``;
- ``eval_s``: the seconds the abstract evaluation took on the host.

The JAX keys with no one-card counterpart are left out: ``collectives``,
``hlo_ops``, ``lower_s`` / ``compile_s`` and ``bytes_per_device`` read the
partitioned, compiled HLO, and the port compiles no program per cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out <dir>

``--all`` exits 1 where a cell failed (the card would raise there too).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.kernels import work
from repro_torch.launch.steps import build_step
from repro_torch.models.common import tree_leaves

OUT_NAME = "dryrun_1card.json"


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """Tallies the bytes of the storages that the ops run under it make:
    each new storage's bytes are added when an op first returns it and
    taken off when it dies, so ``peak`` is the most bytes live at once.
    Storages of ``exclude`` (the arguments) are not counted.

    ``aten.bincount`` has no meta kernel (its length depends on the data);
    on ``meta`` it gives ``minlength`` bins, which is what the port's one
    caller (the MoE's expert counts, every index an expert id) gets."""

    def __init__(self, exclude=()):
        super().__init__()
        self._live: Dict[int, int] = {}
        self._known = {t.untyped_storage()._cdata for t in _tensors(exclude)}
        self.live = self.peak = 0

    def _drop(self, key: int):
        self.live -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten.bincount.default
                and args[0].device.type == "meta"):
            minlength = args[2] if len(args) > 2 else kwargs.get(
                "minlength", 0)
            out = torch.empty(minlength, dtype=torch.long, device="meta")
        else:
            out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        return out


def evaluate(spec) -> Dict[str, Any]:
    """Run ``spec.fn`` on ``spec.args`` (meta) once under the tallies:
    {"flops", "kernel_flops", "argument_bytes", "output_bytes",
    "temp_bytes"}."""
    work.FLOPS.clear()
    arg_bytes = storage_bytes(spec.args)
    counter = FlopCounterMode(display=False)
    with counter, LiveBytes(exclude=spec.args) as mem:
        out = spec.fn(*spec.args)
    kernel_flops = {k: float(v) for k, v in work.FLOPS.items()}
    return {"flops": float(counter.get_total_flops())
            + sum(kernel_flops.values()),
            "kernel_flops": kernel_flops, "argument_bytes": arg_bytes,
            "output_bytes": storage_bytes(out), "temp_bytes": mem.peak}


def dryrun_cell(arch: str, shape_name: str,
                verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "chips": 1}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    t0 = time.monotonic()
    spec = build_step(cfg, shape, device="meta")
    got = evaluate(spec)
    mem = {k: got[k] for k in ("argument_bytes", "output_bytes",
                               "temp_bytes")}
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    rec.update({
        "status": "ok",
        "program": spec.name,
        "eval_s": round(time.monotonic() - t0, 2),
        "flops_per_device": got["flops"],
        "kernel_flops": got["kernel_flops"],
        "memory": mem,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    if verbose:
        gib = lambda n: n / 2**30
        print(f"  {arch:22s} {shape_name:12s} {spec.name:13s} "
              f"{rec['eval_s']:6.2f}s args {gib(mem['argument_bytes']):8.2f} "
              f"GiB tmp {gib(mem['temp_bytes']):8.2f} GiB "
              f"{got['flops'] / 1e12:12.1f} TFLOP", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"dir for the JSON results ({OUT_NAME})")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("give --arch and/or --shape, or --all")

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    t0 = time.monotonic()
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            t1 = time.monotonic()
            try:
                rec = dryrun_cell(arch, shape)
            except Exception as e:          # the cell's own failure, kept
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "chips": 1,
                       "status": "fail", "reason": f"{type(e).__name__}: {e}",
                       "eval_s": round(time.monotonic() - t1, 2)}
                failures.append((arch, shape))
            records.append(rec)
    print(f"{len(records)} cells in {time.monotonic() - t0:.1f}s: "
          + ", ".join(f"{sum(r['status'] == s for r in records)} {s}"
                      for s in ("ok", "skip", "fail")), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, OUT_NAME)
        # merge with an earlier run's (per-cell reruns update in place)
        merged: Dict[Any, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                for r in json.load(f):
                    merged[(r["arch"], r["shape"])] = r
        for r in records:
            merged[(r["arch"], r["shape"])] = r
        with open(path, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"-> {path}", flush=True)
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        return 1
    print("all dry-run cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

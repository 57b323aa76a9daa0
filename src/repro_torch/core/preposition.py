"""Prepositioning on CUDA cards (paper T4): the port's counterpart of
``repro.core.preposition``.

The paper copies whole application installs onto every node's local disk so
process start-up never touches central storage. On a TPU the artefact that
stands between "user hits enter" and "first step executes" is the XLA
executable. The port compiles nothing per (arch, shape); what stands there
on a card is

  * the kernels' shared library: its ``nvcc`` build when the sources are
    new, and its ``dlopen`` (``kernels.build.load``);
  * the first step's one-off costs: the CUDA context, cuBLAS handles and
    their heuristics, the caching allocator's pools, lazy module loading.

``CompileCacheWarmer`` pays both before the session, once per (arch, shape,
devices), by loading the library and running one member step on throwaway
inputs of the member's shapes; ``WeightPrepositioner`` materializes the
base params on the device ahead of the session. An interactive sweep of N
members then launches with no build, no first-call cost and no host to
device weight transfer in the interactive loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import build as kernel_build

CacheKey = Tuple[str, str, Tuple[str, ...]]


def device_names(devices: Sequence) -> Tuple[str, ...]:
    return tuple(str(d) for d in devices)


def cache_key(cfg: ArchConfig, shape: ShapeConfig,
              devices: Sequence) -> CacheKey:
    """Keyed by device identity, not by the number of devices: a step warmed
    on ``cuda:0`` has not paid ``cuda:1``'s first-call costs."""
    return (cfg.name, shape.name, device_names(devices))


@dataclass
class WarmEntry:
    step: Any                 # the member step (the reference's `compiled`)
    build_s: float            # build (when cold) and load of the kernels
    first_step_s: float       # one step on throwaway inputs, synchronized


class CompileCacheWarmer:
    """Warm member steps for an interactive session.

    ``warm(...)`` is the slow path run *before* the session (the rsync of
    MATLAB installs); ``get(...)`` is the interactive fast path and never
    builds or runs anything — a miss raises, because first-call costs inside
    the interactive loop are precisely the failure mode the paper
    engineered away.
    """

    def __init__(self):
        self._cache: Dict[CacheKey, WarmEntry] = {}
        self.stats = {"warms": 0, "hits": 0, "misses": 0}

    def warm(self, cfg: ArchConfig, shape: ShapeConfig, devices: Sequence,
             build: Callable[[], Any]) -> WarmEntry:
        """build() -> (step, make_args): the member step and a function
        that makes throwaway inputs of the member's shapes. The step runs
        once on them; they are dropped after it."""
        key = cache_key(cfg, shape, devices)
        if key in self._cache:
            return self._cache[key]
        step, make_args = build()
        cards = [d for d in map(torch.device, devices) if d.type == "cuda"]
        build_s = 0.0                  # the CPU runs the plain versions
        if cards:
            t0 = time.monotonic()
            kernel_build.load()
            build_s = time.monotonic() - t0
        args = make_args()
        t0 = time.monotonic()
        step(*args)
        for d in cards:
            torch.cuda.synchronize(d)
        entry = WarmEntry(step, build_s, time.monotonic() - t0)
        self._cache[key] = entry
        self.stats["warms"] += 1
        return entry

    def get(self, cfg: ArchConfig, shape: ShapeConfig,
            devices: Sequence) -> WarmEntry:
        key = cache_key(cfg, shape, devices)
        if key not in self._cache:
            self.stats["misses"] += 1
            raise KeyError(
                f"warm cache cold for {key} — warm() it before the "
                f"interactive session (paper T4)")
        self.stats["hits"] += 1
        return self._cache[key]


class WeightPrepositioner:
    """Materialize params on the device ahead of the interactive session.

    Keyed by (arch, devices, seed). For a sweep of N models that share the
    base architecture, the prepositioned tree is initialized ONCE; the
    port's optimizer works in place, so each member trains its own
    device-side clone of it.
    """

    def __init__(self):
        self._store: Dict[Tuple[str, Tuple[str, ...], int], Any] = {}

    def preposition(self, cfg: ArchConfig, devices: Sequence, seed: int,
                    init: Callable[[], Any]):
        key = (cfg.name, device_names(devices), seed)
        if key not in self._store:
            self._store[key] = init()
        return self._store[key]

    def get(self, cfg: ArchConfig, devices: Sequence, seed: int):
        key = (cfg.name, device_names(devices), seed)
        if key not in self._store:
            raise KeyError(f"weights not prepositioned for {key}")
        return self._store[key]

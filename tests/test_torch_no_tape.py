"""Training leaves no autograd state behind, and serving records no graph
(``repro_torch.launch.sweep`` and ``repro_torch.serve``, on the CPU).

JAX keeps no tape: its member step returns new params and its engine's
prefill and decode are pure functions. The port differentiates detached
aliases of the param leaves, so a member step leaves every leaf as it found
it, and prefill, decode and the engine run under ``torch.no_grad``, so even
params that do require grad build no graph through the cache's in-place
writes (which would chain each tick's graph onto the last and keep every
step's activations alive).

Sizes: the sweep member (``member_config``: 4 ATTN layers, d_model 128,
vocab 256) on one ``SyntheticLM(256, 32, 8)`` batch, then an engine of 2
slots and 128 positions serving 2 prompts for 20 ticks (40 new tokens each,
so both are still decoding).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data import SyntheticLM
from repro_torch.launch.sweep import build_member_step, member_config
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw_init
from repro_torch.serve.engine import ServeEngine

TICKS = 20


@pytest.fixture(scope="module")
def trained():
    """(cfg, params, params before the step): one member step from seed 0."""
    cfg = member_config("qwen3-0.6b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = tree_map(torch.clone, params)
    step = build_member_step(cfg, device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch(0)
    params, _, loss = step(params, adamw_init(params), batch, 1e-3)
    assert np.isfinite(float(loss))
    return cfg, params, before


def _serve(cfg, params):
    """(tokens per request, cache) after ``TICKS`` ticks of a 2-slot engine."""
    eng = ServeEngine(cfg, params, slots=2, max_seq=128, device="cpu")
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=40)
            for n in (9, 23)]
    reqs = list(eng.queue)
    for _ in range(TICKS):
        assert eng.tick()
    assert not eng.done and [r.rid for r in reqs] == rids
    return [list(r.tokens) for r in reqs], eng.cache


def test_member_step_leaves_no_leaf_requiring_grad(trained):
    _, params, before = trained
    leaves = tree_leaves(params)
    assert leaves and not any(t.requires_grad for t in leaves)
    assert all(t.grad is None and t.grad_fn is None for t in leaves)
    # the step still updated the caller's leaves in place
    moved = [not torch.equal(a, b) for a, b in zip(leaves,
                                                   tree_leaves(before))]
    assert all(moved)


@pytest.mark.parametrize("params_kind", ["trained", "requiring grad"])
def test_serving_records_no_graph(trained, params_kind):
    """No cache leaf has a ``grad_fn`` after 20 ticks, and the tokens equal
    those of an engine on a detached copy of the same params."""
    cfg, params, _ = trained
    if params_kind == "requiring grad":
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          params)
    tokens, cache = _serve(cfg, params)
    leaves = tree_leaves(cache)
    assert leaves and all(t.grad_fn is None and not t.requires_grad
                          for t in leaves)
    want, _ = _serve(cfg, tree_map(lambda t: t.detach().clone(), params))
    assert all(len(t) == TICKS + 1 for t in tokens)
    assert tokens == want


def test_chip_smoke_check_of_serving_trained_params(trained):
    """``chip_smoke.py``'s card check after training, run here on the CPU:
    it passes on the trained params and refuses params requiring grad."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, params, _ = trained
    smoke.check_serving_trained(cfg, params, device="cpu")
    marked = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    with pytest.raises(RuntimeError, match="requires grad"):
        smoke.check_serving_trained(cfg, marked, device="cpu")

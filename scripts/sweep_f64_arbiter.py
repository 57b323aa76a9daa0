#!/usr/bin/env python3
"""The sweep test's fp32 runs against a float64 arbiter, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/sweep_f64_arbiter.py

``tests/test_torch_sweep.py::test_run_sweep_matches_the_jax_sweep`` holds
the port's ``run_sweep`` member (reduced qwen3-0.6b, 2 layers, fp32) to the
JAX sweep's ``member_step`` after 3 steps at lr 1e-4 and 3e-2. This script
prints, for the same params (drawn in fp32 from ``PRNGKey(0)``) and
batches:

1. each step's loss of four runs: JAX jitted (the test's reference), JAX
   op by op (``jax.disable_jit``: the same math in another summation
   order), the port, and a float64 run (JAX with x64 enabled and its
   models' ``F32`` set to float64; the logits still round to bf16 as the
   model says), and each fp32 run's final distance from the float64 one;
2. at step 0, each fp32 gradient's largest distance from the float64
   gradient (relative to the leaf's largest magnitude), its relative RMS
   distance, how many elements have the other sign and how large (relative
   to their leaf's largest) the float64 gradient is there;
3. for each fp32 run at lr 3e-2, the float64 run fed that run's step-0
   gradient in place of its own (steps 1 and 2 float64), and its final
   distance from the float64 run: how much of the fp32 run's distance its
   step-0 gradient alone explains.

It imports JAX and the JAX package, like the tests; nothing of the port's
package depends on it.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax

jax.config.update("jax_enable_x64", True)   # arrays stay fp32 unless cast

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train.step import loss_and_grads, to_batch  # noqa: E402

STEPS, LRS = 3, (1e-4, 3e-2)
F32_MODULES = ("repro.models.common", "repro.models.attention",
               "repro.models.mlp", "repro.models.model",
               "repro.models.blocks", "repro.optim.adamw")


def jax_config():
    return dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               n_layers=2, param_dtype="float32",
                               remat="none")


def jax_step(cfg):
    def step(params, opt, batch, lr):
        (loss, _), grads = jax.value_and_grad(
            lambda p: JM.forward_loss(p, cfg, batch), has_aux=True)(params)
        params, opt, _ = jax_adamw.adamw_update(grads, opt, params, lr=lr)
        return params, opt, loss
    return step


def jax_losses(step, params, lr, dtype, grads0=None):
    """The losses of STEPS steps; ``grads0``, where given, is applied at
    step 0 in place of the step's own gradient."""
    src = JaxSyntheticLM(256, 32, 8, seed=0)
    opt = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if x.dtype == jnp.float32 else x,
        jax_adamw.adamw_init(params, "float32"))
    out = []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.batch(s).items()}
        if s == 0 and grads0 is not None:
            _, _, loss = step(params, opt, batch, dtype(lr))
            params, opt, _ = jax.jit(jax_adamw.adamw_update)(
                grads0, opt, params, lr=dtype(lr))
        else:
            params, opt, loss = step(params, opt, batch, dtype(lr))
        out.append(float(loss))
    return out


def port_losses(jparams, lr):
    cfg = sweep.member_config("qwen3-0.6b")
    params = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    params = tree_map(torch.clone, params)
    step = sweep.build_member_step(cfg, device="cpu")
    src, opt, out = SyntheticLM(cfg.vocab_size, 32, 8, seed=0), \
        adamw_init(params), []
    for s in range(STEPS):
        params, opt, loss = step(params, opt, src.batch(s), lr)
        out.append(float(loss))
    return out


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def main():
    cfg = jax_config()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))   # fp32 draws
    batch0 = {k: jnp.asarray(v) for k, v in
              JaxSyntheticLM(256, 32, 8, seed=0).batch(0).items()}
    loss0 = lambda p: JM.forward_loss(p, cfg, batch0)[0]
    runs, grads = {}, {}
    step = jax_step(cfg)
    for lr in LRS:
        runs["jax jit", lr] = jax_losses(jax.jit(step), params, lr,
                                         jnp.float32)
        with jax.disable_jit():
            runs["jax op by op", lr] = jax_losses(step, params, lr,
                                                  jnp.float32)
        runs["port", lr] = port_losses(params, lr)
    grads["jax jit"] = jax.jit(jax.grad(loss0))(params)
    with jax.disable_jit():
        grads["jax op by op"] = jax.grad(loss0)(params)
    tp = convert.to_torch(jax.tree_util.tree_map(np.asarray, params), "cpu")
    _, g = loss_and_grads(tp, sweep.member_config("qwen3-0.6b"),
                          to_batch({k: np.asarray(v)
                                    for k, v in batch0.items()}, "cpu"))
    grads["port"] = convert.to_numpy(g)
    for name in F32_MODULES:                 # now the float64 run
        importlib.import_module(name).F32 = jnp.float64
    p64 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)
    for lr in LRS:
        runs["float64", lr] = jax_losses(jax.jit(step), p64, lr, jnp.float64)
    g64 = leaves(jax.jit(jax.grad(loss0))(p64))
    fed = {name: jax_losses(jax.jit(step), p64, LRS[-1], jnp.float64,
                            jax.tree_util.tree_map(
                                lambda x: jnp.asarray(x, jnp.float64), g))
           for name, g in grads.items()}
    for lr in LRS:
        exact = runs["float64", lr][-1]
        for name in ("jax jit", "jax op by op", "port", "float64"):
            got = runs[name, lr]
            print(f"lr {lr:g} {name:13s} losses "
                  f"{', '.join(f'{x:.9f}' for x in got)}; final "
                  f"{abs(got[-1] - exact) / exact:.3e} from float64")
    for name, tree in grads.items():
        g = leaves(tree)
        worst = max(np.abs(g[k] - g64[k]).max() / np.abs(g64[k]).max()
                    for k in g64)
        rms = np.sqrt(sum(((g[k] - g64[k]) ** 2).sum() for k in g64)
                      / sum((g64[k] ** 2).sum() for k in g64))
        flipped = [abs(g64[k][i]) / np.abs(g64[k]).max() for k in g64
                   for i in zip(*np.nonzero(np.sign(g[k]) != np.sign(g64[k])))]
        print(f"step-0 gradient {name:13s}: max {worst:.3e} of a leaf's "
              f"largest, relative RMS {rms:.3e}, {len(flipped)} of "
              f"{sum(x.size for x in g64.values())} elements of the other "
              f"sign, where float64's is "
              f"{', '.join(f'{x:.2e}' for x in sorted(flipped))} of its "
              f"leaf's largest")
    exact = runs["float64", LRS[-1]][-1]
    for name, got in fed.items():
        print(f"lr {LRS[-1]:g} float64 fed {name:13s}'s step-0 gradient: "
              f"losses {', '.join(f'{x:.9f}' for x in got)}; final "
              f"{abs(got[-1] - exact) / exact:.3e} from float64")


if __name__ == "__main__":
    main()

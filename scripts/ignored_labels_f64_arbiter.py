#!/usr/bin/env python3
"""``test_torch_train.py::test_forward_loss_with_ignored_labels``'s fp32
gradients against a float64 arbiter, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/ignored_labels_f64_arbiter.py

The test holds every gradient leaf of the port's ``loss_and_grads`` to the
JAX package's jitted ``value_and_grad(forward_loss)`` within 2e-5 of the
leaf's largest magnitude (the sweep's member config, fp32 params, tokens
and labels from ``default_rng(30)``). This script computes the same
gradients a third time, through the port with every float param in
float64 (the logits still round to bf16 and their loss is still taken in
fp32, as the model says), and prints for each leaf, with no labels
ignored and with some: the port's distance from that run, JAX's, and the
port's from JAX (the test's number), each relative to the leaf's largest
magnitude. Then, for the tokens both cases share, the fp32 logits of both
packages before their bf16 rounding: their largest distance relative to
the largest logit, how many of them round to different bf16 values, and
each such logit's distance from the bf16 rounding midpoint between them,
relative to the largest logit.

It imports JAX and the JAX package, like the tests; nothing of the port's
package depends on it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch import convert
from repro_torch.launch.sweep import loss_and_grads, member_config, to_batch
from repro_torch.models.common import rms_norm, tree_map
from repro_torch.models.model import forward_hidden


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def main():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               n_layers=2, param_dtype="float32",
                               remat="none")
    tcfg = member_config("qwen3-0.6b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    t64 = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                   tparams)
    for ignore in ("none", "some"):
        rng = np.random.default_rng(30)
        tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
        labels = tokens.copy()
        if ignore == "some":
            labels[rng.random(labels.shape) < 0.3] = -1
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        jg = leaves(jax.jit(jax.grad(
            lambda p: JM.forward_loss(p, jcfg, jb)[0]))(jparams))
        batch = to_batch({"tokens": tokens, "labels": labels}, "cpu")
        tg = leaves(convert.to_numpy(loss_and_grads(tparams, tcfg, batch)[1]))
        g64 = leaves(convert.to_numpy(loss_and_grads(t64, tcfg, batch)[1]))
        for k in jg:
            print(f"ignore {ignore:4s} {k:32s} port {rel(tg[k], g64[k]):.3e}"
                  f", JAX {rel(jg[k], g64[k]):.3e} from float64; port vs "
                  f"JAX {rel(tg[k], jg[k]):.3e}")
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
    jl = np.array(jnp.matmul(jax_rms_norm(jh, jparams["final_norm"],
                                          jcfg.norm_eps),
                             jparams["embed"].T,
                             preferred_element_type=jnp.float32))
    with torch.no_grad():
        th, _ = forward_hidden(tparams, tcfg, batch["tokens"])
        tl = torch.matmul(rms_norm(th, tparams["final_norm"], tcfg.norm_eps),
                          tparams["embed"].T).numpy()
    bf = lambda x: torch.from_numpy(x).bfloat16().double().numpy()
    flips = np.nonzero(bf(jl) != bf(tl))
    top = np.abs(jl).max()
    mids = (bf(jl)[flips] + bf(tl)[flips]) / 2
    off = np.maximum(np.abs(jl[flips] - mids), np.abs(tl[flips] - mids))
    print(f"fp32 logits: port vs JAX {np.abs(tl - jl).max() / top:.3e} of "
          f"the largest; {len(mids)} of {jl.size} round to another bf16 "
          f"value, at {', '.join(f'{x:.1e}' for x in sorted(off / top))} "
          f"of the largest from the midpoint")


if __name__ == "__main__":
    main()

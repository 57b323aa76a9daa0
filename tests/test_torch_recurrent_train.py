"""One train step of the recurrent archs on the CPU, the port against the
JAX package's step composed in the test: reduced ``xlstm-1.3b`` (7 mLSTM +
1 sLSTM layers, d_model 128) and reduced ``zamba2-2.7b`` (4 Mamba-2 layers,
the shared attention block applied twice), in bf16 and fp32, with 1 and 2
microbatches. Their gradients run through the scans' ``autograd.Function``s
(the plain backwards on CPU tensors) and, in zamba2, the flash attention's.

As ``tests/test_torch_trainstep.py`` does (``make_train_step`` raises under
the installed jax), the JAX side is ``forward_loss`` and
``jax.value_and_grad`` per microbatch, the fp32 mean over microbatches,
``cosine_warmup`` and ``adamw_update``; both sides start from the same
state (JAX's init, converted) at step 1 (lr 5e-4).

Tolerances:
- fp32 (fp32 moments on both sides): the reduced xlstm's gradients are
  ill-conditioned in fp32: JAX against itself with ``ssd_chunked``'s chunk
  halved (another summation order, nothing else) moves a gradient leaf by
  up to ~1.6e-3 of its largest magnitude. So each gradient leaf, the loss
  and the grad norm are held to twice that distance of JAX's (the port at
  most twice as far from JAX as JAX's own rounding moves it) plus 2e-5 of
  the leaf's largest magnitude (1e-6 for the loss and norm); each updated
  param and moment to 1e-6 of its terms plus what the two sides' gradients
  move a float64 AdamW update by (Adam's first step is ~lr sign(g)).
- bf16 (the arch's own moments: bf16 for xlstm, fp32 for zamba2), as the
  trainstep test's bf16 case: the loss within twice the mean over tokens of
  JAX's bf16 per-token loss deviation from its fp32 step, the grad norm
  within twice the norm of JAX's bf16 gradient error, every updated param
  and moment within twice JAX's bf16 step's largest distance from its
  fp32 step plus what the gradients move a float64 update by.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.optim import adamw_init
from repro_torch.train.step import make_train_step, microbatch_grads, to_batch

PEAK_LR, WARMUP, TOTAL, STEP = 1e-3, 2, 10, 1
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
ARCHS = ("xlstm-1.3b", "zamba2-2.7b")


def _config(arch, dtype, k, moments=None):
    cfg = jax_get_config(arch).reduced()
    return dataclasses.replace(cfg, param_dtype=dtype, microbatches=k,
                               opt_state_dtype=moments or cfg.opt_state_dtype)


def _batch():
    return JaxSyntheticLM(256, 32, 4, seed=0).batch(STEP)


def _paths(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float64)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The reduced arch's params in bf16 (the fp32 runs cast them)."""
    cfg = _config(arch, "bfloat16", 1)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda key: JM.init_params(cfg, key))(
            jax.random.PRNGKey(0)))


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(dtype)
                                  if x.dtype in (jnp.bfloat16, jnp.float32)
                                  else jnp.asarray(x), tree)


def _jax_grads(cfg, params, batch, k):
    """The reference step's microbatch loop: fp32 sums, then / k."""
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, cfg, b)[0]))
    B = batch["tokens"].shape[0]
    acc, loss_acc = None, 0.0
    for i in range(k):
        mb = {n: jnp.asarray(x[i * B // k:(i + 1) * B // k])
              for n, x in batch.items()}
        loss, g = grad(params, mb)
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
        loss_acc = loss_acc + loss
    return loss_acc / k, jax.tree_util.tree_map(lambda g: g / k, acc)


def _jax_step(cfg, params, batch, k):
    """The composed reference step from ``params`` and fresh moments."""
    loss, grads = _jax_grads(cfg, params, batch, k)
    opt = jax_adamw.adamw_init(params, cfg.opt_state_dtype)
    lr = jax_cosine_warmup(jnp.int32(STEP), peak_lr=PEAK_LR,
                           warmup_steps=WARMUP, total_steps=TOTAL)
    new_p, new_o, gn = jax_adamw.adamw_update(grads, opt, params, lr=lr)
    return {"loss": float(loss), "grad_norm": float(gn), "lr": float(lr),
            "grads": _paths(grads), "p": _paths(new_p),
            "m": _paths(new_o["m"]), "v": _paths(new_o["v"])}


def _port_step(cfg, params, batch, k):
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    tp = convert.to_torch(jax.tree_util.tree_map(np.asarray, params), "cpu")
    _, grads = microbatch_grads(tp, tcfg, to_batch(batch, "cpu"), k)
    step = make_train_step(tcfg, peak_lr=PEAK_LR, warmup=WARMUP,
                           total_steps=TOTAL, device="cpu")
    tp, to, m = step(tp, adamw_init(tp, cfg.opt_state_dtype), batch, STEP)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "grads": _paths(convert.to_numpy(grads)),
            "p": _paths(convert.to_numpy(tp)),
            "m": _paths(convert.to_numpy(to["m"])),
            "v": _paths(convert.to_numpy(to["v"]))}


def _adam64(g, p, lr):
    """One leaf's first AdamW step (zero moments, count 1) in float64 from
    already-clipped ``g``, and the magnitudes its fp32 rounding is relative
    to."""
    m1, v1 = g * (1 - B1), g * g * (1 - B2)
    den = np.sqrt(v1 / (1 - B2)) + EPS
    step = (m1 / (1 - B1)) / den
    if p.ndim >= 2:
        step = step + WD * p
    p_terms = np.abs(p) + lr * (np.abs(step) + np.abs(m1) / (1 - B1) / den)
    return (p - lr * step, m1, v1), (p_terms, np.abs(m1), v1)


def _moved(port, ref, p0, lr):
    """{path: ([|dp|, |dm|, |dv|], [terms])}: what the two sides' gradients
    move a float64 update from ``p0`` by, and the larger side's terms."""
    out = {}
    for path, p in p0.items():
        a, ta = _adam64(port["grads"][path] * min(1.0, 1 / port["grad_norm"]),
                        p, lr)
        b, tb = _adam64(ref["grads"][path] * min(1.0, 1 / ref["grad_norm"]),
                        p, lr)
        out[path] = ([np.abs(x - y) for x, y in zip(a, b)],
                     [np.maximum(x, y) for x, y in zip(ta, tb)])
    return out


@functools.lru_cache(maxsize=None)
def _jax_fp32(arch, k, chunk=None):
    """JAX's fp32 step (fp32 moments); with ``chunk`` its SSD scans run in
    chunks of that length instead of min(256, T)."""
    cfg = _config(arch, "float32", k, "float32")
    saved = (jax_xlstm.mlstm_forward.__defaults__,
             jax_ssm.mamba2_forward.__defaults__)
    try:
        if chunk:
            jax_xlstm.mlstm_forward.__defaults__ = (chunk,)
            jax_ssm.mamba2_forward.__defaults__ = (chunk,)
        return _jax_step(cfg, _cast(_init(arch), jnp.float32), _batch(), k)
    finally:
        (jax_xlstm.mlstm_forward.__defaults__,
         jax_ssm.mamba2_forward.__defaults__) = saved


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_recurrent_step_vs_composed_jax(arch, k):
    want = _jax_fp32(arch, k)
    alt = _jax_fp32(arch, k, chunk=16)           # JAX in another sum order
    cfg = _config(arch, "float32", k, "float32")
    got = _port_step(cfg, _cast(_init(arch), jnp.float32), _batch(), k)
    for key in ("loss", "grad_norm"):
        floor = abs(alt[key] - want[key])
        assert abs(got[key] - want[key]) <= 2 * floor + 1e-6 * abs(want[key])
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert got["grads"].keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        floor = np.abs(alt["grads"][path] - w).max()
        err = np.abs(got["grads"][path] - w).max()
        assert err <= 2 * floor + 2e-5 * np.abs(w).max(), (path, err, floor)
    p0 = _paths(_cast(_init(arch), jnp.float32))
    moved = _moved(got, want, p0, want["lr"])
    for i, kind in enumerate("pmv"):
        for path, w in want[kind].items():
            dist, terms = moved[path]
            err = np.abs(got[kind][path] - w)
            assert (err <= 1e-6 * terms[i] + dist[i]).all(), (kind, path)


@functools.lru_cache(maxsize=None)
def _jax_token_nll(arch, dtype):
    """Per-token next-token losses of ``forward_loss`` (all labels valid)."""
    cfg = _config(arch, dtype, 1)

    @jax.jit
    def nll(params, tokens):
        h, _ = JM.forward_hidden(params, cfg, tokens)
        logits = JM.lm_logits(params, cfg, h)[:, :-1].astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, tokens[:, 1:, None], axis=-1)
        return lse - tgt[..., 0]
    return nll


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_recurrent_step_vs_composed_jax(arch, k):
    cfg = _config(arch, "bfloat16", k)
    params = _cast(_init(arch), jnp.bfloat16)
    want16 = _jax_step(cfg, params, _batch(), k)
    want32 = _jax_fp32(arch, k)
    got = _port_step(cfg, params, _batch(), k)
    tokens = jnp.asarray(_batch()["tokens"])
    nll_floor = float(jnp.mean(jnp.abs(
        _jax_token_nll(arch, "bfloat16")(params, tokens)
        - _jax_token_nll(arch, "float32")(_cast(params, jnp.float32),
                                          tokens))))
    assert abs(got["loss"] - want32["loss"]) <= 2 * nll_floor
    gn_floor = np.sqrt(sum(np.sum((want16["grads"][q] - want32["grads"][q])
                                  ** 2) for q in want16["grads"]))
    assert abs(got["grad_norm"] - want32["grad_norm"]) <= 2 * gn_floor
    assert got["lr"] == pytest.approx(want16["lr"], rel=1e-6)
    p0 = _paths(params)
    moved = _moved(got, want16, p0, want16["lr"])
    for i, kind in enumerate("pmv"):
        assert got[kind].keys() == want16[kind].keys()
        for path, exact in want32[kind].items():
            err = np.abs(got[kind][path] - exact)
            floor = np.abs(want16[kind][path] - exact).max()
            assert (err <= 2 * floor + moved[path][0][i]).all(), \
                (kind, path, err.max(), floor)

"""The MoE's backward (``models/mlp.py``) against JAX's autodiff on the CPU,
and one train step of reduced moonshot-v1-16b-a3b and mixtral-8x22b
against the JAX package's step composed in the test.

Inputs come from a numpy seed; weights are JAX's own init carried across
by ``repro_torch.convert``. Every case that compares gradients first
asserts that the port and JAX route the same way (the same top-k
experts for every token), so that a near-tie fails there, with its count,
and not as a gradient mismatch; except the bf16 train step, where ties
cannot be avoided at 4 layers and 160 tokens and the port's routing is
held to twice JAX's own bf16 distance from the fp32 model's routing
(``_assert_step_routes_alike``).

Cases and tolerances:
- The dispatch and the combine alone (``_Dispatch``, ``_Combine`` and
  ``_Permute`` on ``route``'s indices) against ``jax.vjp`` of the JAX
  package's gather and scatter-adds (``repro/models/mlp.py:83-118``) on the
  same routing, with drops (capacity factor 1.0) and unfilled slots: the
  outputs, dx and dy_buf the same bits in both dtypes (each token's
  cotangents are added in the order JAX's scatter-add meets them). The
  weights' gradient sums over d, whose order differs: fp32 within 1e-5
  of its largest magnitude, bf16 within twice JAX's own bf16 distance
  from its fp32 gradient.
- ``bmm_f32``'s gradients against ``jax.vjp`` of ``einsum(...,
  preferred_element_type=F32)``: bf16 within one bf16 ulp of JAX's
  (both round an fp32 product of the fp32 cotangent, accumulated in
  another order), fp32 within 1e-5 of the largest magnitude.
- ``moe_forward``'s gradients with respect to x, the router, ``w_up``,
  ``w_gate`` and ``w_down``, with the aux loss, against
  ``jax.value_and_grad`` for the arch cases of ``tests/test_torch_moe.py``,
  both dtypes, with and without drops, at that file's tolerances: fp32
  within 1e-5 of each leaf's largest magnitude, bf16 within twice JAX's
  own bf16 distance from its fp32 gradients on the same bf16-rounded
  inputs.
- One train step (``make_train_step``) at microbatches 1 and 2, bf16 and
  fp32, against the step of ``tests/test_torch_recurrent_train.py``
  (``forward_loss`` and ``jax.value_and_grad`` per microbatch, the fp32
  mean, ``cosine_warmup``, ``adamw_update``) on ``SyntheticLM`` 2 x 80:
  mixtral's reduced 64-token window binds. fp32 as
  ``tests/test_torch_trainstep.py`` holds the dense step: the loss 1e-6
  relative, the grad norm 1e-5, every gradient leaf 2e-5 of its largest
  magnitude, every updated param and moment 1e-6 of its terms plus what
  the two sides' gradients move a float64 update by. bf16 as the
  recurrent test's bf16 case: the loss within twice the mean over tokens
  of JAX's bf16 per-token loss deviation from its fp32 step, the grad
  norm within twice the norm of JAX's bf16 gradient error, every updated
  param and moment within twice JAX's bf16 step's largest distance from
  its fp32 step plus what the gradients move a float64 update by.
- remat full against remat none: the same bits, loss and every gradient.
- ``python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b
  --device cpu --steps 2`` prints ``done at step 2``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import blocks as jax_blocks
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.models.common import matmul as jax_matmul
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.models import blocks as port_blocks
from repro_torch.models import forward_hidden as port_forward_hidden
from repro_torch.models import mlp as TMLP
from repro_torch.models.common import matmul as port_matmul
from repro_torch.models.common import tree_leaves
from repro_torch.train.step import loss_and_grads, to_batch
from test_torch_recurrent_train import (_cast, _config, _init, _jax_step,
                                        _jax_token_nll, _moved, _paths,
                                        _port_step)

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_ARCHS = ["moonshot_v1_16b_a3b", "mixtral_8x22b",
             "moonshot_v1_16b_a3b-wide"]
WIDE = {"n_experts": 16, "top_k": 6}     # tests/test_torch_moe.py's
TRAIN_ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b")
TRAIN_BATCH = (2, 80)                    # past reduced mixtral's window


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(
        a, np.float32)


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _rng(seed):
    return np.random.default_rng(seed)


def _bits_equal(got, want):
    assert got.shape == tuple(want.shape)
    assert np.array_equal(_np(got), _np(want)), _max_diff(got, want)


# --------------------------------------------------------------------------
# the dispatch and the combine alone
# --------------------------------------------------------------------------
N_TOK, N_EXP, TOP, D = 64, 8, 3, 16


def _routing(seed=5):
    """Top-3 of 8 experts for 64 tokens from random logits, the
    renormalised fp32 top-k probabilities, and C at capacity factor 1.0:
    some experts overflow (drops) and some do not fill (empty slots)."""
    logits = _rng(seed).standard_normal((N_TOK, N_EXP)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, TOP)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    C = int(max(1, round(N_TOK * TOP / N_EXP * 1.0)))
    counts = np.bincount(np.asarray(top_e).reshape(-1), minlength=N_EXP)
    assert counts.max() > C and counts.min() < C, (counts, C)
    return np.asarray(top_p), np.asarray(top_e), counts, C


def _jax_indices(top_e, C):
    """``repro/models/mlp.py:83-96``'s indices."""
    flat_e = jnp.asarray(top_e).reshape(-1)
    sort_idx = jnp.argsort(flat_e)
    sorted_e = flat_e[sort_idx]
    starts = jnp.searchsorted(sorted_e, jnp.arange(N_EXP), side="left")
    pos_in_e = jnp.arange(flat_e.shape[0]) - starts[sorted_e]
    keep = pos_in_e < C
    return (sort_idx, sort_idx // TOP, keep, jnp.where(keep, sorted_e, 0),
            jnp.where(keep, pos_in_e, 0))


def _jax_dispatch(xf, top_e, C):
    _, token_of, keep, e_idx, c_idx = _jax_indices(top_e, C)
    src = jnp.where(keep[:, None], xf[token_of], 0)
    return jnp.zeros((N_EXP, C, xf.shape[1]), xf.dtype).at[
        e_idx, c_idx].add(src)


def _jax_combine(y_buf, top_p, top_e, C):
    sort_idx, token_of, keep, e_idx, c_idx = _jax_indices(top_e, C)
    gathered = jnp.where(keep[:, None], y_buf[e_idx, c_idx], 0)
    w = top_p.reshape(-1)[sort_idx].astype(y_buf.dtype)
    return jnp.zeros((N_TOK, y_buf.shape[-1]), y_buf.dtype).at[
        token_of].add(gathered * w[:, None])


def _port_indices(top_e, counts, C):
    return TMLP.route(torch.tensor(top_e).long(), torch.tensor(counts), C)


def _leaf(x, tdt):
    return torch.from_numpy(np.array(x, np.float32)).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_backward_is_jax_bits(dtype):
    """dx: each token's kept slots' cotangents added in ascending expert
    order, dropped ones adding nothing, as JAX's transpose of the gather."""
    jdt, tdt = DTYPES[dtype]
    _, top_e, counts, C = _routing()
    rng = _rng(6)
    x = jnp.asarray(rng.standard_normal((N_TOK, D)), jdt)
    dbuf = jnp.asarray(rng.standard_normal((N_EXP, C, D)), jdt)
    buf, vjp = jax.vjp(lambda x: _jax_dispatch(x, top_e, C), x)
    (dx,) = vjp(dbuf)
    token, filled, slots, _ = _port_indices(top_e, counts, C)
    tx = _leaf(x, tdt).requires_grad_(True)
    tbuf = TMLP._Dispatch.apply(tx, token, filled, slots)
    tbuf.backward(_leaf(dbuf, tdt))
    _bits_equal(tbuf.detach(), buf)
    _bits_equal(tx.grad, dx)
    assert tx.grad.dtype == tdt


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_combine_backward_is_jax_bits(dtype):
    """dy_buf: each kept slot gets its token's cotangent times its weight
    (unfilled and dropped slots nothing); the weights' gradient within the
    module's tolerance (a sum over d in another order)."""
    jdt, tdt = DTYPES[dtype]
    top_p, top_e, counts, C = _routing()
    rng = _rng(7)
    y_buf = jnp.asarray(rng.standard_normal((N_EXP, C, D)), jdt)
    dout = jnp.asarray(rng.standard_normal((N_TOK, D)), jdt)

    def jax_grads(y_buf, top_p):
        out, vjp = jax.vjp(lambda y, p: _jax_combine(y, p, top_e, C),
                           y_buf, top_p)
        return (out, *vjp(dout.astype(y_buf.dtype)))

    out, dy, dp = jax_grads(y_buf, jnp.asarray(top_p))
    _, _, slots, order = _port_indices(top_e, counts, C)
    ty = _leaf(y_buf, tdt).requires_grad_(True)
    tp = torch.from_numpy(top_p).requires_grad_(True)
    tout = TMLP._Combine.apply(ty, TMLP._Permute.apply(tp.to(tdt), order),
                               slots)
    tout.backward(_leaf(dout, tdt))
    _bits_equal(tout.detach(), out)
    _bits_equal(ty.grad, dy)
    if dtype == "float32":
        assert _max_diff(tp.grad, dp) <= FP32_TOL * float(np.abs(dp).max())
        return
    _, _, dp32 = jax_grads(y_buf.astype(jnp.float32), jnp.asarray(top_p))
    jax_dev = _max_diff(dp, dp32)
    assert 0 < jax_dev and _max_diff(tp.grad, dp32) <= 2 * jax_dev


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bmm_f32_backward_matches_jax(dtype):
    """The fp32 cotangent times the other operand upcast, in fp32, cast to
    the operand's dtype: JAX's transpose of ``preferred_element_type=F32``.
    In bf16 a product of the cotangent rounded to bf16 would be farther
    from it than one ulp, as the last assert shows."""
    jdt, tdt = DTYPES[dtype]
    rng = _rng(8)
    a = jnp.asarray(rng.standard_normal((3, 24, 32)), jdt)
    b = jnp.asarray(rng.standard_normal((3, 32, 40)) / 6, jdt)
    g = jnp.asarray(rng.standard_normal((3, 24, 40)) / 3, jnp.float32)
    y, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "ecd,edf->ecf", a, b, preferred_element_type=jnp.float32), a, b)
    da, db = vjp(g)
    ta, tb = (_leaf(t, tdt).requires_grad_(True) for t in (a, b))
    ty = TMLP.bmm_f32(ta, tb)
    assert ty.dtype == torch.float32
    ty.backward(torch.from_numpy(np.asarray(g)))
    assert _max_diff(ty.detach(), y) <= 1e-6 * float(np.abs(y).max())
    for got, want in ((ta.grad, da), (tb.grad, db)):
        assert got.dtype == tdt
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            assert _max_diff(got, want) <= FP32_TOL * np.abs(want).max()
        else:                               # one bf16 ulp: 2^-7 relative
            err = np.abs(_np(got) - want)
            assert (err <= 2.0 ** -7 * np.abs(want)).all(), err.max()
    if dtype == "bfloat16":
        rounded = torch.bmm(torch.from_numpy(np.asarray(g)).to(tdt),
                            tb.detach().transpose(1, 2))
        assert _max_diff(rounded, da) > _max_diff(ta.grad, da)


# --------------------------------------------------------------------------
# moe_forward's gradients
# --------------------------------------------------------------------------
def _moe_cfgs(arch, **kw):
    if arch.endswith("-wide"):
        arch, kw = arch.removesuffix("-wide"), {**WIDE, **kw}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32", remat="none", **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _jax_logits(p, cfg, x):
    xf = x.reshape(-1, x.shape[-1])
    return np.asarray(jax_matmul(xf, p["router"].astype(xf.dtype),
                                 out_dtype=jnp.float32))


def _port_logits(p, cfg, x):
    xf = x.reshape(-1, x.shape[-1])
    return port_matmul(xf, p["router"].to(xf.dtype),
                       out_dtype=torch.float32).numpy()


def _chosen(logits, k):
    """[N, E] bool: the top-k experts of softmax(logits)."""
    top = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                                   k)[1])
    out = np.zeros(logits.shape, bool)
    np.put_along_axis(out, top, True, axis=-1)
    return out


def _differ(got, want, k):
    """Tokens whose top-k experts differ between two [N, E] logits."""
    return int((_chosen(got, k) != _chosen(want, k)).any(-1).sum())


LEAVES = ("router", "w_up", "w_gate", "w_down")


def _jax_moe_grads(jp, jcfg, x, ct):
    def loss(p, x):
        y, aux = JMLP.moe_forward(p, jcfg, x)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux
    val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(jp, x)
    return float(val), {"x": gx, **{k: gp[k] for k in LEAVES}}


def _port_moe_grads(tp, tcfg, x, ct):
    tp = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    x = x.detach().requires_grad_(True)
    y, aux = TMLP.moe_forward(tp, tcfg, x)
    loss = torch.sum(y.float() * ct) + aux
    loss.backward()
    return float(loss.detach()), {"x": x.grad, **{k: tp[k].grad for k in LEAVES}}


@pytest.mark.parametrize("drops", [False, True], ids=["capacity", "drops"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_grads_match_jax(arch, dtype, drops):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _moe_cfgs(arch, **({"capacity_factor": 1.0} if drops
                                    else {}))
    jp = JMLP.init_moe_params(jax.random.PRNGKey(7), jcfg, jdt)
    tp = convert.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = _rng(13)
    x_np = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    ct_np = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x_np).astype(jdt), torch.from_numpy(x_np).to(tdt)
    logits = _jax_logits(jp, jcfg, jx)
    flips = _differ(_port_logits(tp, tcfg, tx), logits, jcfg.top_k)
    assert flips == 0, f"{flips} tokens route differently (a tie)"
    counts = _chosen(logits, jcfg.top_k).sum(0)
    C = TMLP.capacity(tcfg, 64, inference=False)
    assert (counts.max() > C) == drops, (counts, C)
    want_loss, want = _jax_moe_grads(jp, jcfg, jx, jnp.asarray(ct_np))
    got_loss, got = _port_moe_grads(tp, tcfg, tx, torch.from_numpy(ct_np))
    assert all(got[k].dtype == tp[k].dtype for k in LEAVES)
    if dtype == "float32":
        assert abs(got_loss - want_loss) <= FP32_TOL * abs(want_loss)
        for k, w in want.items():
            assert _max_diff(got[k], w) <= FP32_TOL * float(
                np.abs(_np(w)).max()), k
        return
    # JAX's fp32 gradients on the same bf16-rounded inputs and weights
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jx32 = jx.astype(jnp.float32)
    flips = _differ(_jax_logits(jp32, jcfg, jx32), logits, jcfg.top_k)
    assert flips == 0, f"JAX fp32 vs bf16: {flips} tokens route differently"
    _, ref = _jax_moe_grads(jp32, jcfg, jx32, jnp.asarray(ct_np))
    for k, r in ref.items():
        jax_dev = _max_diff(want[k], r)
        assert 0 < jax_dev and _max_diff(got[k], r) <= 2 * jax_dev, (
            k, _max_diff(got[k], r), jax_dev)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------
def _train_batch():
    return JaxSyntheticLM(256, TRAIN_BATCH[1], TRAIN_BATCH[0],
                          seed=0).batch(1)


@contextlib.contextmanager
def _recording(module, store, logits):
    """Each MoE block's router logits, as ``module``'s blocks route."""
    saved = module.moe_forward

    def recording(p, cfg, x, inference=False):
        store.append(logits(p, cfg, x))
        return saved(p, cfg, x, inference=inference)

    module.moe_forward = recording
    try:
        yield
    finally:
        module.moe_forward = saved


@functools.lru_cache(maxsize=None)
def _step_logits(arch, dtype, k):
    """Per microbatch, per layer: (the port's router logits, JAX's), the
    forwards run as the step in ``dtype`` runs them. JAX's runs eagerly
    (its scan as a loop, no remat, which changes no forward value), so its
    router inputs are concrete."""
    cfg = dataclasses.replace(_config(arch, dtype, k), remat="none")
    params = _cast(_init(arch), DTYPES[dtype][0])
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    tp = convert.to_torch(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tokens = _train_batch()["tokens"]
    B, out = tokens.shape[0], []
    for i in range(k):
        mb = tokens[i * B // k:(i + 1) * B // k]
        want, got = [], []
        with _recording(jax_blocks, want, _jax_logits), jax.disable_jit():
            JM.forward_hidden(params, cfg, jnp.asarray(mb))
        with _recording(port_blocks, got, _port_logits), torch.no_grad():
            port_forward_hidden(tp, tcfg, torch.from_numpy(mb).long())
        assert len(got) == len(want) == cfg.n_layers
        out.append(list(zip(got, want)))
    return out


def _assert_step_routes_alike(arch, dtype, k):
    """fp32: the port's top-k experts equal JAX's at every layer of every
    microbatch. bf16 (against the fp32 model on the same params): the two bf16
    models' layer inputs differ by bf16 roundings, and at this size a few
    of 160 tokens sit on router ties at every batch seed tried (0-5; 6 of
    640 token-layers differ from JAX's for moonshot at seed 0), so the
    port's choices are held as its other bf16 results are: they differ
    from the fp32 model's at no more token-layers than twice JAX's bf16
    choices do (11 and 11 of 640 for moonshot, 5 and 5 for mixtral)."""
    runs, top_k = _step_logits(arch, dtype, k), _config(arch, dtype, k).top_k
    if dtype == "float32":
        for i, layers in enumerate(runs):
            for layer, (got, want) in enumerate(layers):
                flips = _differ(got, want, top_k)
                assert flips == 0, (f"microbatch {i} layer {layer}: {flips} "
                                    "tokens route differently (a tie)")
        return
    pairs = [(g, w, r) for layers, ref in zip(
        runs, _step_logits(arch, "float32", k))
        for (g, w), (_, r) in zip(layers, ref)]
    port = sum(_differ(g, r, top_k) for g, _, r in pairs)
    jax_own = sum(_differ(w, r, top_k) for _, w, r in pairs)
    assert port <= 2 * jax_own, (
        f"the port's bf16 routing differs from the fp32 model's at {port} "
        f"token-layers, JAX's bf16 at {jax_own}")


@functools.lru_cache(maxsize=None)
def _jax_fp32_step(arch, k):
    cfg = _config(arch, "float32", k, "float32")
    return _jax_step(cfg, _cast(_init(arch), jnp.float32), _train_batch(), k)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fp32_moe_step_vs_composed_jax(arch, k):
    cfg = _config(arch, "float32", k, "float32")
    params = _cast(_init(arch), jnp.float32)
    _assert_step_routes_alike(arch, "float32", k)
    want = _jax_fp32_step(arch, k)
    got = _port_step(cfg, params, _train_batch(), k)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert got["grads"].keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        err = np.abs(got["grads"][path] - w).max()
        assert err <= 2e-5 * np.abs(w).max(), (path, err)
    moved = _moved(got, want, _paths(params), want["lr"])
    for i, kind in enumerate("pmv"):
        for path, w in want[kind].items():
            dist, terms = moved[path]
            err = np.abs(got[kind][path] - w)
            assert (err <= 1e-6 * terms[i] + dist[i]).all(), (kind, path)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_moe_step_vs_composed_jax(arch, k):
    cfg = _config(arch, "bfloat16", k)
    params = _cast(_init(arch), jnp.bfloat16)
    _assert_step_routes_alike(arch, "bfloat16", k)
    want16 = _jax_step(cfg, params, _train_batch(), k)
    want32 = _jax_fp32_step(arch, k)
    got = _port_step(cfg, params, _train_batch(), k)
    tokens = jnp.asarray(_train_batch()["tokens"])
    nll_floor = float(jnp.mean(jnp.abs(
        _jax_token_nll(arch, "bfloat16")(params, tokens)
        - _jax_token_nll(arch, "float32")(_cast(params, jnp.float32),
                                          tokens))))
    assert abs(got["loss"] - want32["loss"]) <= 2 * nll_floor
    gn_floor = np.sqrt(sum(np.sum((want16["grads"][q] - want32["grads"][q])
                                  ** 2) for q in want16["grads"]))
    assert abs(got["grad_norm"] - want32["grad_norm"]) <= 2 * gn_floor
    assert got["lr"] == pytest.approx(want16["lr"], rel=1e-6)
    moved = _moved(got, want16, _paths(params), want16["lr"])
    for i, kind in enumerate("pmv"):
        assert got[kind].keys() == want16[kind].keys()
        for path, exact in want32[kind].items():
            err = np.abs(got[kind][path] - exact)
            floor = np.abs(want16[kind][path] - exact).max()
            assert (err <= 2 * floor + moved[path][0][i]).all(), \
                (kind, path, err.max(), floor)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_full_equals_remat_none_bit_for_bit(arch):
    """Under remat full the backward recomputes each block: the same
    routing, the same drops (capacity factor 1.0 here), the same bits."""
    cfg = dataclasses.replace(_config(arch, "bfloat16", 1),
                              capacity_factor=1.0)
    params = convert.to_torch(jax.tree_util.tree_map(
        np.asarray, _init(arch)), "cpu")
    batch = to_batch(_train_batch(), "cpu")
    runs = [loss_and_grads(params, ArchConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, remat=remat))), batch)
        for remat in ("full", "none")]
    (loss_f, g_f), (loss_n, g_n) = runs
    assert torch.equal(loss_f, loss_n)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_f),
                                                 tree_leaves(g_n)))


def test_launch_train_cli_moonshot_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "moonshot-v1-16b-a3b", "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ckpt")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "arch=moonshot-v1-16b-a3b-smoke device=cpu" in proc.stdout
    assert "done at step 2" in proc.stdout

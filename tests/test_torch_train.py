"""The port's member step (``repro_torch.launch.sweep``) on the CPU, against
the JAX package's own: ``forward_loss`` -> gradients -> ``adamw_update``,
``SyntheticLM`` batches and ``cosine_warmup``.

The JAX side is ``repro.launch.sweep.build_member_step`` itself, jitted, at
the sweep's config (``member_config``: 4 ATTN layers, d_model 128, hd 32,
fp32 params) and its default ``attn_impl="chunked"`` (the sequence of 32 is
shorter than its query block, so it runs ``attend_naive``). The port's side
runs its kernels' plain versions and their plain backward formulas (CPU
tensors). Weights and moments cross through ``repro_torch.convert``.

Tolerances (fp32, same math in another summation order):
- losses 1e-6 relative from the same params, 1e-5 along three independent
  steps of each side (their params drift apart by the update noise below);
- grad norm 1e-5 relative;
- every gradient leaf 2e-5 of its largest magnitude;
- updated params and moments: 1e-6 relative rounding plus what the two
  sides' (checked) gradients move the update by, computed in float64 from
  the same moments. That second term is needed: Adam's first step is
  ``g / |g|`` elementwise, so wherever |g| sits within the gradients'
  agreement its sign is noise and the two updates may differ by up to
  2 lr; later steps divide by a small running |g| in the same way.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import sweep as jax_sweep
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch.sweep import (build_member_step, loss_and_grads,
                                      member_config, to_batch)
from repro_torch.models import forward_loss
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup

LR = 1e-3                 # inside the sweep's grid, np.geomspace(1e-4, 3e-2)
STEPS = 3
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def _jax_member_config():
    """``repro/launch/sweep.py:66-68``."""
    return dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               n_layers=2, param_dtype="float32",
                               remat="none")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    """{key path: numpy leaf} of a JAX-layout numpy tree."""
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_max(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_member_config_is_the_sweeps_with_four_layers():
    """``n_layers=2`` leaves ``reduced()``'s 4-layer block pattern in place,
    in both packages: the member has 4 ATTN layers."""
    cfg = member_config("qwen3-0.6b")
    assert cfg == ArchConfig(**dataclasses.asdict(_jax_member_config()))
    assert cfg.n_layers == 2 and cfg.block_pattern == ("attn",) * 4
    assert (cfg.d_model, cfg.head_dim, cfg.vocab_size) == (128, 32, 256)
    assert cfg.param_dtype == "float32" and cfg.attn_impl == "chunked"


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 4), (3, 1), (7, 2)])
def test_synthetic_lm_batches_bit_for_bit(seed, step):
    want = JaxSyntheticLM(256, 32, 8, seed=seed).batch(step)
    got = SyntheticLM(256, 32, 8, seed=seed).batch(step)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# --------------------------------------------------------------------------
# forward_loss
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def member_params():
    jcfg = _jax_member_config()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, member_config("qwen3-0.6b"), jparams


@pytest.mark.parametrize("ignore", ["none", "some", "all"])
def test_forward_loss_with_ignored_labels(member_params, ignore):
    """Labels of -1 take no part in the loss or its gradient; with every
    label ignored the loss is 0 (the denominator is clamped to 1)."""
    jcfg, tcfg, jparams = member_params
    rng = np.random.default_rng(30)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = tokens.copy()
    if ignore == "some":
        labels[rng.random(labels.shape) < 0.3] = -1
    elif ignore == "all":
        labels[:] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.forward_loss(p, jcfg, jb), has_aux=True))(jparams)
    tparams = convert.to_torch(_np(jparams), device="cpu")
    tloss, tgrads = loss_and_grads(tparams, tcfg, to_batch(
        {"tokens": tokens, "labels": labels}, "cpu"))
    _, metrics = forward_loss(tparams, tcfg, to_batch(
        {"tokens": tokens, "labels": labels}, "cpu"))
    assert float(metrics["ntokens"]) == float(jmetrics["ntokens"])
    if ignore == "all":
        assert float(tloss) == float(jloss) == 0.0
        assert all(not g.any() for g in _paths(convert.to_numpy(tgrads))
                   .values())
        return
    assert _rel(tloss, jloss) < 1e-6
    got = _paths(convert.to_numpy(tgrads))
    for path, want in _paths(_np(jgrads)).items():
        assert _rel_max(got[path], want) < 2e-5, path


# --------------------------------------------------------------------------
# adamw_update, clip_by_global_norm, cosine_warmup
# --------------------------------------------------------------------------
def _opt_tree(seed, grad_scale, count):
    """A tree shaped like the member's (stacked stage leaves, stacked gains
    [L, d], an unstacked final_norm [d]) with params, grads and moments."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": f(16, 8) * 0.02, "final_norm": 1 + 0.1 * f(8),
              "stages": [{"ln1": 1 + 0.1 * f(3, 8),
                          "attn": {"wq": f(3, 8, 4) * 0.3,
                                   "q_norm": 1 + 0.1 * f(3, 4)}}]}
    grads = jax.tree_util.tree_map(lambda p: f(*p.shape) * grad_scale, params)
    m = jax.tree_util.tree_map(lambda p: f(*p.shape) * 0.01, params)
    v = jax.tree_util.tree_map(lambda p: np.abs(f(*p.shape)) * 1e-4, params)
    return params, grads, {"m": m, "v": v, "count": np.int32(count)}


@pytest.mark.parametrize("grad_scale,count", [(1e-3, 0), (1e-3, 7), (10.0, 0),
                                              (10.0, 3)])
def test_adamw_update_matches_jax(grad_scale, count):
    """Identical params, grads and moments: the global norm is below the
    limit of 1 at grad_scale 1e-3 and far above it at 10 (clipped)."""
    params, grads, opt = _opt_tree(31, grad_scale, count)
    jp, jo, jgn = jax_adamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, opt),
        jax.tree_util.tree_map(jnp.asarray, params), lr=LR)
    tp, to, tgn = adamw_update(convert.to_torch(grads, "cpu"),
                               convert.to_torch(opt, "cpu"),
                               convert.to_torch(params, "cpu"), lr=LR)
    assert (float(jgn) < 1) == (grad_scale < 1)
    assert _rel(tgn, jgn) < 1e-6
    assert int(to["count"]) == int(jo["count"]) == count + 1
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        got, want = _paths(convert.to_numpy(got)), _paths(_np(want))
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                       atol=1e-9, err_msg=path)


@pytest.mark.parametrize("seed", [32, 34])
def test_weight_decay_reaches_stacked_gains_but_not_final_norm(seed):
    """Decay goes to every leaf with ndim >= 2 of the stacked tree, which
    includes the stacked gains [L, d] and not final_norm [d], as in JAX."""
    params, grads, opt = _opt_tree(seed, 0.0, 0)
    # zero grads and moments: Adam's step is 0, the decay is all that moves
    grads, opt["m"], opt["v"] = (jax.tree_util.tree_map(np.zeros_like, t)
                                 for t in (grads, opt["m"], opt["v"]))
    tp = convert.to_torch(params, "cpu")
    adamw_update(convert.to_torch(grads, "cpu"), convert.to_torch(opt, "cpu"),
                 tp, lr=LR)
    jp, _, _ = jax_adamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, opt),
        jax.tree_util.tree_map(jnp.asarray, params), lr=LR)
    got, want = _paths(convert.to_numpy(tp)), _paths(_np(jp))
    before = _paths(params)
    for path, p0 in before.items():
        if p0.ndim >= 2:
            assert not np.array_equal(got[path], p0), path
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   err_msg=path)
    stage = "['stages'][0]"
    assert before[f"{stage}['ln1']"].ndim == 2
    np.testing.assert_allclose(got[f"{stage}['ln1']"],
                               before[f"{stage}['ln1']"] * (1 - LR * WD),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["['final_norm']"],
                                  before["['final_norm']"])


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 40, 99, 100, 150])
def test_cosine_warmup_matches_jax(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    want = float(jax_cosine_warmup(jnp.int32(step), **kw))
    assert float(cosine_warmup(step, **kw)) == pytest.approx(want, rel=1e-6)
    assert float(cosine_warmup(torch.tensor(step), **kw)) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize("seed,count", [(33, 5), (35, 0)])
def test_adamw_state_crosses_convert_both_ways(seed, count):
    _, _, opt = _opt_tree(seed, 1.0, count)
    jopt = jax_adamw.adamw_init(jax.tree_util.tree_map(jnp.asarray,
                                                       opt["m"]), "float32")
    for tree in (opt, _np(jopt)):
        back = convert.to_numpy(convert.to_torch(tree, "cpu"))
        assert back["count"].dtype == np.int32 and back["count"].shape == ()
        for path, want in _paths(tree).items():
            np.testing.assert_array_equal(_paths(back)[path], want)


# --------------------------------------------------------------------------
# the member step against the JAX sweep's member_step
# --------------------------------------------------------------------------
def _adam64(g, m, v, p, count, clip):
    """The update of one leaf in float64 (the reference of the tolerance):
    the new (p, m, v) and, for each, the magnitude of the terms its fp32
    rounding is relative to. The new m sums terms that may cancel, and its
    rounding reaches p through Adam's step, divided by the step's
    denominator."""
    g, m, v, p = (np.asarray(t, np.float64) for t in (g, m, v, p))
    g = g * clip
    m1 = m * B1 + g * (1 - B1)
    v1 = v * B2 + g * g * (1 - B2)
    c1 = 1 - B1 ** count
    den = np.sqrt(v1 / (1 - B2 ** count)) + EPS
    step = (m1 / c1) / den
    if p.ndim >= 2:
        step = step + WD * p
    m_terms = np.abs(m * B1) + np.abs(g * (1 - B1))
    p_terms = np.abs(p) + LR * (np.abs(step) + m_terms / c1 / den)
    return (p - LR * step, m1, v1), (p_terms, m_terms, v1)


@pytest.fixture(scope="module")
def member_run():
    """Three member steps on each side from the same params and batches,
    and at each step the port's step from JAX's current params and
    moments (converted), beside JAX's gradients at the same point."""
    jcfg, tcfg = _jax_member_config(), member_config("qwen3-0.6b")
    jax_step = jax.jit(jax_sweep.build_member_step(jcfg,
                                                   make_host_mesh(1, 1))[0])
    jax_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, jcfg, b)[0]))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jo = jax_adamw.adamw_init(jp, "float32")
    tp = convert.to_torch(_np(jp), device="cpu")
    to = adamw_init(tp)
    member_step = build_member_step(tcfg, device="cpu")
    jsrc, src = JaxSyntheticLM(256, 32, 8, seed=0), SyntheticLM(256, 32, 8,
                                                               seed=0)
    steps = []
    for step in range(STEPS):
        batch = src.batch(step)
        jb = {k: jnp.asarray(v) for k, v in jsrc.batch(step).items()}
        before = {"params": _np(jp), "opt": _np(jo)}
        j_loss, j_grads = jax_grad(jp, jb)
        _, j_gn = jax_adamw.clip_by_global_norm(j_grads, 1.0)
        sp = convert.to_torch(before["params"], device="cpu")
        so = convert.to_torch(before["opt"], device="cpu")
        s_loss, s_grads = loss_and_grads(sp, tcfg, to_batch(batch, "cpu"))
        s_grads_np = convert.to_numpy(s_grads)
        sp, so, s_gn = adamw_update(s_grads, so, sp, lr=LR)
        jp, jo, j_chain_loss = jax_step(jp, jo, jb, jnp.float32(LR))
        tp, to, t_chain_loss = member_step(tp, to, batch, LR)
        steps.append({
            "before": before, "count": int(before["opt"]["count"]) + 1,
            "jax": {"loss": float(j_loss), "gn": float(j_gn),
                    "grads": _np(j_grads), "params": _np(jp), "opt": _np(jo),
                    "chain_loss": float(j_chain_loss)},
            "port": {"loss": float(s_loss), "gn": float(s_gn),
                     "grads": s_grads_np, "params": convert.to_numpy(sp),
                     "opt": convert.to_numpy(so),
                     "chain_loss": float(t_chain_loss)}})
    return steps


@pytest.mark.parametrize("step", range(STEPS))
def test_member_step_loss_matches_jax(member_run, step):
    r = member_run[step]
    assert _rel(r["port"]["loss"], r["jax"]["loss"]) < 1e-6
    assert _rel(r["port"]["chain_loss"], r["jax"]["chain_loss"]) < 1e-5
    # the step reports the loss at the params it starts from
    assert r["jax"]["chain_loss"] == pytest.approx(r["jax"]["loss"], rel=1e-6)
    if step:
        assert r["port"]["chain_loss"] < member_run[0]["port"]["chain_loss"]


@pytest.mark.parametrize("step", range(STEPS))
def test_member_step_grad_norm_matches_jax(member_run, step):
    r = member_run[step]
    assert _rel(r["port"]["gn"], r["jax"]["gn"]) < 1e-5


@pytest.mark.parametrize("step", range(STEPS))
def test_member_step_gradients_match_jax(member_run, step):
    r = member_run[step]
    got, want = _paths(r["port"]["grads"]), _paths(r["jax"]["grads"])
    assert got.keys() == want.keys() and len(want) == 13
    for path in want:
        assert got[path].shape == want[path].shape
        assert _rel_max(got[path], want[path]) < 2e-5, path


@pytest.mark.parametrize("step", range(STEPS))
def test_member_step_updates_match_jax(member_run, step):
    """Every updated param and moment, within 1e-6 relative plus the part of
    the update that the two sides' gradients move it by (module doc)."""
    r = member_run[step]
    count = r["count"]
    assert int(r["port"]["opt"]["count"]) == int(r["jax"]["opt"]["count"]) \
        == count
    grads = {side: _paths(r[side]["grads"]) for side in ("port", "jax")}
    clip = {side: min(1.0, 1.0 / r[side]["gn"]) for side in ("port", "jax")}
    p0 = _paths(r["before"]["params"])
    m0 = _paths(r["before"]["opt"]["m"])
    v0 = _paths(r["before"]["opt"]["v"])
    got, want = ({"p": _paths(r[side]["params"]),
                  "m": _paths(r[side]["opt"]["m"]),
                  "v": _paths(r[side]["opt"]["v"])} for side in ("port", "jax"))
    for path in p0:
        ref = {side: _adam64(grads[side][path], m0[path], v0[path], p0[path],
                             count, clip[side]) for side in ("port", "jax")}
        for i, key in enumerate("pmv"):
            moved = np.abs(ref["port"][0][i] - ref["jax"][0][i])
            tol = 1e-6 * ref["jax"][1][i] + moved
            err = np.abs(got[key][path].astype(np.float64) - want[key][path])
            assert (err <= tol).all(), (path, key, float((err - tol).max()))

"""The port's train step (``repro_torch.train.step``) on the CPU, against the
JAX package's step composed in the test, at the reduced qwen3 config (4 ATTN
layers, d_model 128, hd 32, vocab 256) in bf16, the reference's default
dtype, and in fp32.

The JAX oracle cannot be ``repro.train.step.make_train_step``, which raises
under the installed jax (its explicit mesh axes), so the test composes the
same step from the JAX package's own parts: ``forward_loss`` and
``jax.value_and_grad`` per microbatch, the fp32 mean over microbatches,
``compress_residual`` per leaf under int8, ``cosine_warmup`` and
``adamw_update``. The port's side runs its kernels' plain versions (CPU
tensors). Variants: microbatches 1 and 2, remat none and full, grad
compression off and int8, each value in both dtypes.

Tolerances:
- fp32, each step from the same state (JAX's, converted): the loss 1e-6
  relative, the grad norm 1e-5, the lr 1e-6, every gradient leaf 2e-5 of
  its largest magnitude, every updated param and moment 1e-6 of its terms
  plus what the two sides' gradients move the update by (computed in
  float64: Adam's step is ~g/|g| elementwise, so where |g| is within the
  gradients' agreement the two updates may differ by up to 2 lr), as in
  ``tests/test_torch_train.py``; the losses along three chained steps 1e-5.
- bf16, each of three steps from the same state (JAX's bf16 run's): every
  updated param and moment leaf's distance from JAX's fp32 step must stay
  within twice the largest of JAX's bf16 step's own (the port at most twice
  as far from the exact result as JAX), plus, elementwise, what the two
  sides' bf16 gradients move a float64 update by (the sign noise above,
  and under int8 a gradient that lands on the other side of a
  quantisation step); the loss within twice the mean over
  tokens of JAX's bf16 per-token loss deviation; the grad norm within twice
  the norm of JAX's bf16 gradient error (a mean, or a norm, moves by at
  most the mean, or the norm, of its terms' moves); the lr 1e-6.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim import compress as port_compress
from repro_torch.train.step import (init_train_state, make_train_step,
                                    microbatch_grads, to_batch)

PEAK_LR, WARMUP, TOTAL = 1e-3, 2, 10     # lr 0, 5e-4, 1e-3 at steps 0..2
STEPS = 3
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
# (microbatches, remat, grad_compress): every value of each axis
VARIANTS = [(1, "none", None), (2, "full", "int8"), (2, "none", None),
            (1, "full", "int8")]


def _jax_config(dtype, k, remat):
    return dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               param_dtype=dtype, microbatches=k,
                               remat=remat)


def _port_config(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float64)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(step):
    return JaxSyntheticLM(256, 32, 4, seed=0).batch(step)


@functools.lru_cache(maxsize=None)
def _jax_grad(dtype, k):
    """jitted value_and_grad of ``forward_loss`` at one microbatch size
    (remat does not change JAX's values: one function per dtype and k)."""
    cfg = _jax_config(dtype, k, "none")
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, cfg, b)[0]))


def _jax_grads(dtype, k, params, batch):
    """The reference step's microbatch loop: fp32 sums, then / k."""
    grad = _jax_grad(dtype, k)
    B = batch["tokens"].shape[0]
    g_acc = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                   params)
    loss_acc = jnp.zeros((), jnp.float32)
    for i in range(k):
        mb = {n: jnp.asarray(x[i * B // k:(i + 1) * B // k])
              for n, x in batch.items()}
        loss, g = grad(params, mb)
        g_acc = jax.tree_util.tree_map(lambda a, x: a + x.astype(jnp.float32),
                                       g_acc, g)
        loss_acc = loss_acc + loss
    return loss_acc / k, jax.tree_util.tree_map(lambda g: g / k, g_acc)


@jax.jit
def _jax_compress(grads):
    return jax.tree_util.tree_map(
        lambda g: jax_compress.compress_residual(g)[0], grads)


@jax.jit
def _jax_update(grads, opt, params, step):
    lr = jax_cosine_warmup(step, peak_lr=PEAK_LR, warmup_steps=WARMUP,
                           total_steps=TOTAL)
    params, opt, gn = jax_adamw.adamw_update(grads, opt, params, lr=lr)
    return params, opt, gn, lr


def _jax_step(dtype, k, compress, params, opt, batch, step):
    """The composed reference step; ``raw_grads`` are the gradients before
    compression, ``grads`` what the update used."""
    loss, raw = _jax_grads(dtype, k, params, batch)
    grads = _jax_compress(raw) if compress == "int8" else raw
    params, opt, gn, lr = _jax_update(grads, opt, params, jnp.int32(step))
    return params, opt, {"loss": loss, "lr": lr, "grad_norm": gn,
                         "grads": grads, "raw_grads": raw}


def _port_step(jcfg, compress):
    return make_train_step(_port_config(jcfg), peak_lr=PEAK_LR,
                           warmup=WARMUP, total_steps=TOTAL,
                           grad_compress=compress, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The reduced qwen3's params in bf16 (every run starts from them, the
    fp32 runs cast) and fresh fp32 moments."""
    cfg = _jax_config("bfloat16", 1, "none")
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(0))
    return params, jax_adamw.adamw_init(params, "float32")


@functools.lru_cache(maxsize=None)
def _jax_chain(dtype, k, compress):
    """Three chained JAX steps in ``dtype`` from the bf16 init (cast):
    [(params, opt, metrics)] after each step."""
    params, _ = _jax_init()
    params = jax.tree_util.tree_map(lambda p: p.astype(dtype), params)
    opt = jax_adamw.adamw_init(params, "float32")
    out = []
    for s in range(STEPS):
        params, opt, m = _jax_step(dtype, k, compress, params, opt,
                                   _batch(s), s)
        out.append((_np(params), _np(opt), {key: _np(v) for key, v in
                                            m.items()}))
    return out


# --------------------------------------------------------------------------
# bf16: each of three steps from JAX's state, against JAX's bf16 and fp32
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_token_nll(dtype):
    """Per-token next-token losses of ``forward_loss`` (all labels valid)."""
    cfg = _jax_config(dtype, 1, "none")

    @jax.jit
    def nll(params, tokens):
        h, _ = JM.forward_hidden(params, cfg, tokens)
        logits = JM.lm_logits(params, cfg, h)[:, :-1].astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, tokens[:, 1:, None], axis=-1)
        return lse - tgt[..., 0]
    return nll


def _as_fp32(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32)
                                  if x.dtype == jnp.bfloat16 else x, tree)


def _port_grads(tcfg, params, batch, k, compress):
    """The port's gradients at ``params`` as its update uses them."""
    _, grads = microbatch_grads(params, tcfg, to_batch(batch, "cpu"), k)
    if compress == "int8":
        grads = jax.tree_util.tree_map(
            lambda g: port_compress.compress_residual(g)[0], grads)
    return _paths(convert.to_numpy(grads))


def _moved(g_port, gn_port, g_jax, gn_jax, state, count, lr):
    """{leaf path: (p, m, v)}: what the two sides' gradients move one
    float64 AdamW update from ``state`` by, elementwise."""
    p0, m0 = _paths(state[0]), _paths(state[1]["m"])
    v0 = _paths(state[1]["v"])
    out = {}
    for path in p0:
        a, _ = _adam64(g_port[path] * min(1.0, 1.0 / gn_port), m0[path],
                       v0[path], p0[path], count, lr)
        b, _ = _adam64(g_jax[path] * min(1.0, 1.0 / gn_jax), m0[path],
                       v0[path], p0[path], count, lr)
        out[path] = [np.abs(x - y) for x, y in zip(a, b)]
    return out


@pytest.mark.parametrize("k,remat,compress", VARIANTS)
def test_bf16_train_step_vs_composed_jax(k, remat, compress):
    """Three steps; at each, the port's step and JAX's bf16 and fp32 steps
    from the same state (JAX's bf16 run's, converted; cast to fp32 for the
    fp32 step), held as the module doc says: the loss to twice the mean
    per-token bf16 deviation of JAX's (a mean moves by at most the mean of
    its terms' moves)."""
    jcfg = _jax_config("bfloat16", k, remat)
    tcfg = _port_config(jcfg)
    step = _port_step(jcfg, compress)
    chain = _jax_chain("bfloat16", k, compress)
    jp, jo = _jax_init()
    state = (_np(jp), _np(jo))
    for s in range(STEPS):
        batch = _batch(s)
        params16, opt16, m16 = chain[s]
        p32, o32, m32 = _jax_step("float32", k, compress, _as_fp32(state[0]),
                                  state[1], batch, s)
        tp = convert.to_torch(state[0], "cpu")
        assert tp["embed"].dtype == torch.bfloat16
        gp = _port_grads(tcfg, tp, batch, k, compress)
        tp, to, m = step(tp, convert.to_torch(state[1], "cpu"), batch, s)
        tokens = jnp.asarray(batch["tokens"])
        nll_floor = float(jnp.mean(jnp.abs(
            _jax_token_nll("bfloat16")(state[0], tokens)
            - _jax_token_nll("float32")(_as_fp32(state[0]), tokens))))
        assert abs(float(m["loss"]) - float(m32["loss"])) <= 2 * nll_floor
        g16, g32 = _paths(m16["grads"]), _paths(m32["grads"])
        gn_floor = np.sqrt(sum(np.sum((g16[q] - g32[q]) ** 2) for q in g16))
        assert abs(float(m["grad_norm"]) - float(m32["grad_norm"])) <= \
            2 * gn_floor, s
        assert float(m["lr"]) == pytest.approx(float(m16["lr"]), rel=1e-6)
        assert int(to["count"]) == int(opt16["count"]) == s + 1
        got = {"p": _paths(convert.to_numpy(tp)),
               "m": _paths(convert.to_numpy(to["m"])),
               "v": _paths(convert.to_numpy(to["v"]))}
        want16 = {"p": _paths(params16), "m": _paths(opt16["m"]),
                  "v": _paths(opt16["v"])}
        want32 = {"p": _paths(p32), "m": _paths(o32["m"]),
                  "v": _paths(o32["v"])}
        moved = _moved(gp, float(m["grad_norm"]), g16, float(m16["grad_norm"]),
                       state, s + 1, float(m16["lr"]))
        for i, kind in enumerate("pmv"):
            assert got[kind].keys() == want16[kind].keys()
            for path, exact in want32[kind].items():
                err = np.abs(got[kind][path] - exact)
                floor = np.abs(want16[kind][path] - exact).max()
                tol = 2 * floor + moved[path][i]
                assert (err <= tol).all(), (s, kind, path, err.max(), floor)
        state = (params16, opt16)


# --------------------------------------------------------------------------
# fp32: each step from JAX's state, and the chained losses
# --------------------------------------------------------------------------
def _adam64(g, m, v, p, count, lr):
    """One leaf's AdamW update in float64 from already-clipped ``g``, and
    the magnitude of the terms its fp32 rounding is relative to."""
    m1 = m * B1 + g * (1 - B1)
    v1 = v * B2 + g * g * (1 - B2)
    c1 = 1 - B1 ** count
    den = np.sqrt(v1 / (1 - B2 ** count)) + EPS
    step = (m1 / c1) / den
    if p.ndim >= 2:
        step = step + WD * p
    m_terms = np.abs(m * B1) + np.abs(g * (1 - B1))
    p_terms = np.abs(p) + lr * (np.abs(step) + m_terms / c1 / den)
    return (p - lr * step, m1, v1), (p_terms, m_terms, v1)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("k,remat,compress", VARIANTS)
def test_fp32_train_step_vs_composed_jax(k, remat, compress):
    jcfg = _jax_config("float32", k, remat)
    tcfg = _port_config(jcfg)
    step = _port_step(jcfg, compress)
    chain = _jax_chain("float32", k, compress)
    jp, _ = _jax_init()
    before = {"params": _np(jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32), jp)), "opt": None}
    before["opt"] = _np(jax_adamw.adamw_init(before["params"], "float32"))
    cp = convert.to_torch(before["params"], "cpu")
    co = adamw_init(cp)
    for s in range(STEPS):
        batch = _batch(s)
        jax_params, jax_opt, jm = chain[s]
        sp = convert.to_torch(before["params"], "cpu")
        so = convert.to_torch(before["opt"], "cpu")
        _, raw = microbatch_grads(sp, tcfg, to_batch(batch, "cpu"), k)
        sp, so, m = step(sp, so, batch, s)
        assert _rel(m["loss"], jm["loss"]) < 1e-6
        assert _rel(m["grad_norm"], jm["grad_norm"]) < 1e-5
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        gp, gj = _paths(convert.to_numpy(raw)), _paths(jm["raw_grads"])
        for path in gj:
            scale = np.abs(gj[path]).max()
            assert np.abs(gp[path] - gj[path]).max() <= 2e-5 * scale, path
        if compress == "int8":    # the update's own grads, each side's
            gp = _paths(convert.to_numpy(jax.tree_util.tree_map(
                lambda g: port_compress.compress_residual(g)[0], raw)))
            gj = _paths(jm["grads"])
        lr = float(jm["lr"])
        count = s + 1
        clip = {"port": min(1.0, 1.0 / float(m["grad_norm"])),
                "jax": min(1.0, 1.0 / float(jm["grad_norm"]))}
        p0, m0 = _paths(before["params"]), _paths(before["opt"]["m"])
        v0 = _paths(before["opt"]["v"])
        got = {"p": _paths(convert.to_numpy(sp)),
               "m": _paths(convert.to_numpy(so["m"])),
               "v": _paths(convert.to_numpy(so["v"]))}
        want = {"p": _paths(jax_params), "m": _paths(jax_opt["m"]),
                "v": _paths(jax_opt["v"])}
        for path in p0:
            ref = {side: _adam64(g[path] * clip[side], m0[path], v0[path],
                                 p0[path], count, lr)
                   for side, g in (("port", gp), ("jax", gj))}
            for i, key in enumerate("pmv"):
                moved = np.abs(ref["port"][0][i] - ref["jax"][0][i])
                # rounding is relative to the larger side's terms: where
                # both gradients are tiny (~1e-9), v's terms differ 25x
                tol = 1e-6 * np.maximum(ref["port"][1][i],
                                        ref["jax"][1][i]) + moved
                err = np.abs(got[key][path] - want[key][path])
                assert (err <= tol).all(), (s, path, key)
        # the chained run: losses of independent steps within 1e-5
        cp, co, cm = step(cp, co, batch, s)
        assert _rel(cm["loss"], jm["loss"]) < 1e-5
        before = {"params": jax_params, "opt": jax_opt}


# --------------------------------------------------------------------------
# the port's own invariants
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_remat_gives_the_same_bits(dtype):
    """remat full and dots recompute the blocks' forwards in the backward;
    on the CPU that changes no bit of two steps' params, moments and
    metrics."""
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = _port_config(_jax_config(dtype, 2, remat))
        params, opt = init_train_state(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, peak_lr=PEAK_LR, warmup=WARMUP,
                               total_steps=TOTAL, device="cpu")
        ms = []
        for s in range(2):
            params, opt, m = step(params, opt, _batch(s + 1), s + 1)
            ms.append(m)
        runs[remat] = (convert.to_numpy(params), convert.to_numpy(opt), ms)
    base = runs["none"]
    for remat in ("full", "dots"):
        for a, b in ((runs[remat][0], base[0]), (runs[remat][1], base[1])):
            for path, want in _paths(b).items():
                np.testing.assert_array_equal(_paths(a)[path], want, path)
        for ma, mb in zip(runs[remat][2], base[2]):
            for key in ("loss", "grad_norm", "lr"):
                assert torch.equal(ma[key], mb[key]), (remat, key)


def test_microbatch_count_invariance():
    """fp32: the mean of two microbatches' losses and gradients equals the
    whole batch's within fp32 rounding (1e-6 relative, 1e-6 of each leaf's
    largest magnitude); the reference's test_microbatch_count_invariance
    trajectory too (rtol 2e-3 over five steps on one batch)."""
    cfg1 = _port_config(_jax_config("float32", 1, "none"))
    cfg2 = dataclasses.replace(cfg1, microbatches=2)
    params, _ = init_train_state(cfg1, seed=0, device="cpu")
    batch = to_batch(_batch(0), "cpu")
    l1, g1 = microbatch_grads(params, cfg1, batch, 1)
    l2, g2 = microbatch_grads(params, cfg2, batch, 2)
    assert _rel(l2, l1) < 1e-6
    for (path, a), b in zip(_paths(convert.to_numpy(g1)).items(),
                            _paths(convert.to_numpy(g2)).values()):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), path
    traj = []
    for cfg in (cfg1, cfg2):
        p, o = init_train_state(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, peak_lr=5e-3, warmup=2, device="cpu")
        losses = []
        for i in range(5):
            p, o, m = step(p, o, _batch(0), i)
            losses.append(float(m["loss"]))
        traj.append(losses)
    np.testing.assert_allclose(traj[1], traj[0], rtol=2e-3, atol=2e-3)


def _run_losses(grad_compress, n):
    cfg = _port_config(_jax_config("float32", 1, "none"))
    p, o = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, peak_lr=5e-3, warmup=2,
                           grad_compress=grad_compress, device="cpu")
    losses = []
    for i in range(n):
        p, o, m = step(p, o, _batch(0), i)
        losses.append(float(m["loss"]))
    return losses


def test_int8_grad_compress_still_converges():
    """The reference's test_train_variants counterparts, on the port."""
    losses = _run_losses("int8", 10)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_int8_close_to_uncompressed():
    np.testing.assert_allclose(_run_losses("int8", 6), _run_losses(None, 6),
                               rtol=0.08, atol=0.05)


def test_train_step_takes_only_known_compression_and_a_card_or_cpu():
    cfg = _port_config(_jax_config("float32", 1, "none"))
    with pytest.raises(ValueError, match="grad_compress"):
        make_train_step(cfg, grad_compress="fp8", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_train_step(cfg)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            init_train_state(cfg)


def test_step_leaves_params_without_grad():
    cfg = _port_config(_jax_config("bfloat16", 2, "full"))
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    assert opt["m"]["embed"].dtype == torch.float32
    step = make_train_step(cfg, device="cpu")
    out_p, out_o, m = step(params, opt, _batch(0), 0)
    assert out_p is params and out_o["m"] is opt["m"]
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert set(m) == {"loss", "lr", "grad_norm"}


# --------------------------------------------------------------------------
# optim: bf16 moments and int8 compression against JAX
# --------------------------------------------------------------------------
def test_adamw_bf16_state_dtype_vs_jax():
    """The reference's test_adamw_bf16_state_dtype on the port, and the
    same update bit for bit against JAX's."""
    p = {"w": jnp.ones((8, 8), jnp.bfloat16)}
    g = {"w": jnp.full((8, 8), 0.01, jnp.bfloat16)}
    jopt = jax_adamw.adamw_init(p, "bfloat16")
    jp, jo, _ = jax_adamw.adamw_update(g, jopt, p, lr=1e-2)
    tp = convert.to_torch(_np(p), "cpu")
    topt = adamw_init(tp, "bfloat16")
    assert topt["m"]["w"].dtype == torch.bfloat16
    tp, to, _ = adamw_update(convert.to_torch(_np(g), "cpu"), topt, tp,
                             lr=1e-2)
    assert to["v"]["w"].dtype == torch.bfloat16
    assert tp["w"].dtype == torch.bfloat16
    assert float((tp["w"].float() - 1).abs().max()) > 0
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        np.testing.assert_array_equal(
            convert.to_numpy(got)["w"].astype(np.float32),
            np.asarray(want["w"], np.float32))


@pytest.mark.parametrize("n,scale", [(256, 1.0), (1000, 3.0), (7, 1e-3),
                                     (513, 0.0), (4096, 1e4)])
def test_int8_codec_bit_exact_vs_jax(n, scale):
    """int8_encode / int8_decode / compress_residual against JAX's on the
    same numpy input, odd sizes padded, an all-zero input (scale clamped at
    1e-12): every output bit for bit."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[::17] = np.round(x[::17] * 2) / 2          # ties for round-half-even
    jq, js, jpad = jax_compress.int8_encode(jnp.asarray(x))
    tq, ts, tpad = port_compress.int8_encode(torch.from_numpy(x))
    assert tpad == jpad == (-n) % 256
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    shape = (n,)
    np.testing.assert_array_equal(
        port_compress.int8_decode(tq, ts, tpad, shape).numpy(),
        np.asarray(jax_compress.int8_decode(jq, js, jpad, shape)))
    for dtype in (jnp.float32, jnp.bfloat16):
        jdec, jres = jax_compress.compress_residual(jnp.asarray(x, dtype))
        tx = convert.to_torch({"x": np.asarray(jnp.asarray(x, dtype))},
                              "cpu")["x"]
        tdec, tres = port_compress.compress_residual(tx)
        for got, want in ((tdec, jdec), (tres, jres)):
            assert got.dtype == tx.dtype
            np.testing.assert_array_equal(
                convert.to_numpy({"t": got})["t"].astype(np.float32),
                np.asarray(want, np.float32))

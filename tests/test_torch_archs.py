"""The port's remaining decoder-only text archs against the JAX package's,
on the CPU: qwen3-14b (qk-norm, GQA), qwen2-1.5b (QKV biases),
moonshot-v1-16b-a3b (MoE blocks) and mixtral-8x22b (MoE blocks and a
sliding window, served from a rolling KV cache).

Reduced configs in fp32 (4 layers, d_model 128, hd 32; mixtral's window
64). The JAX package's own initialised weights are carried across by
``repro_torch.convert``, except qwen2's QKV biases: JAX initialises them to
zero, so the tests draw them from a numpy seed into both trees, where a
missing or misplaced bias shows. Inputs are numpy arrays from a seed;
mixtral's prompts of 70 and 100 tokens run past its window, so its cache
wraps in prefill and again in decode. On CPU tensors the port's kernels
run their plain versions; the JAX side runs its chunked attention (naive
at these lengths).

Tolerances: bf16 logits 1e-2, about one bf16 ulp at the logits' magnitude
here (|logit| < 2, ulp <= 2^-7); caches and hidden states within 1e-5 of
the tensor's largest magnitude (fp32, another summation order); the loss
and its aux within 1e-5 relative. The rolling-cache mirror of
``tests/test_models.py::test_sliding_window_rolling_cache`` keeps that
test's 3e-3.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.common import tree_leaves
from repro_torch.serve.engine import ServeEngine

ARCHS = ["qwen3_14b", "qwen2_1_5b", "moonshot_v1_16b_a3b", "mixtral_8x22b"]
LOGIT_TOL = 1e-2
HIDDEN_TOL = 1e-5
LOSS_RTOL = 1e-5
ROLLING_TOL = 3e-3      # tests/test_models.py's for the same check
BIAS_STD = 0.5

# JAX's decode step compiled once for the module (eager, each call takes ~1 s)
jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32", remat="none")
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _with_random_biases(jparams, seed=9):
    """JAX's params with every attention bias drawn N(0, BIAS_STD^2)."""
    rng = np.random.default_rng(seed)
    stages = []
    for stage in jparams["stages"]:
        attn = dict(stage["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                BIAS_STD * rng.standard_normal(attn[name].shape), jnp.float32)
        stages.append({**stage, "attn": attn})
    return {**jparams, "stages": stages}


_SETUPS = {}


def _setup(arch):
    """(jcfg, tcfg, jparams, tparams), built once per arch."""
    if arch not in _SETUPS:
        jcfg, tcfg = _cfgs(arch)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        if jcfg.qkv_bias:
            jparams = _with_random_biases(jparams)
        tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
        _SETUPS[arch] = jcfg, tcfg, jparams, tparams
    return _SETUPS[arch]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_scaled(got, want, tol):
    scale = max(float(np.abs(_np(want)).max()), 1e-30)
    assert float(np.abs(_np(got) - _np(want)).max()) <= tol * scale


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _prompts(arch, rng, vocab):
    """Past the 64-token window for mixtral; shorter for the rest."""
    lens = (70, 100) if arch == "mixtral_8x22b" else (13, 13)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


# --------------------------------------------------------------------------
# the QKV bias (qwen2)
# --------------------------------------------------------------------------
def test_qkv_bias_init_and_projection():
    """Init gives zero biases in the param dtype, as JAX's; with nonzero
    ones, attention prefill (q/k/v biased before the reshape, RoPE and the
    attention) and one decode step match JAX's, and differ from the same
    layer without its biases."""
    jcfg, tcfg, jparams, tparams = _setup("qwen2_1_5b")
    init = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    attn0 = init["stages"][0]["attn"]
    assert attn0["bq"].shape == (tcfg.n_layers, tcfg.q_dim)
    assert attn0["bk"].shape == attn0["bv"].shape == (tcfg.n_layers,
                                                      tcfg.kv_dim)
    assert all(float(attn0[b].abs().max()) == 0 for b in ("bq", "bk", "bv"))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["stages"][0]["attn"].items()}
    assert float(tp["bk"].abs().max()) > 0
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    jout, (jk, jv) = JA.attn_prefill(jp, jcfg, jnp.asarray(x),
                                     pos=jnp.asarray(pos))
    tout, (tk, tv) = TA.attn_prefill(tp, tcfg, _t(x), pos=_t(pos))
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close_scaled(got, want, HIDDEN_TOL)
    plain = {k: v for k, v in tp.items() if k not in ("bq", "bk", "bv")}
    nobias, _ = TA.attn_prefill(plain, tcfg, _t(x), pos=_t(pos))
    assert float((nobias - tout).abs().max()) > 0.1

    xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jcache = (jnp.pad(jk, ((0, 0), (0, 3), (0, 0), (0, 0))),
              jnp.pad(jv, ((0, 0), (0, 3), (0, 0), (0, 0))))
    tcache = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3))
                   for t in (tk, tv))
    jd, jc = JA.attn_decode(jp, jcfg, jnp.asarray(xd), jcache, cache_len=9)
    td, tc = TA.attn_decode(tp, tcfg, _t(xd), tcache, cache_len=9)
    _close_scaled(td, jd, HIDDEN_TOL)
    _close_scaled(tc[0], jc[0], HIDDEN_TOL)


# --------------------------------------------------------------------------
# prefill and decode against JAX
# --------------------------------------------------------------------------
def _tree_close(got, want, check):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        check(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch):
    """Prefill logits, the caches (mixtral's rolled into its 64 slots), and
    five decode steps with a scalar cache_len against JAX's ``prefill`` and
    ``decode_step``; then the caches after them, leaf for leaf."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    rng = np.random.default_rng(5)
    for tokens in _prompts(arch, rng, jcfg.vocab_size):
        T = tokens.shape[1]
        follow = rng.integers(0, jcfg.vocab_size, (5, 1))
        jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                            pad=8)
        tl, tc = TM.prefill(tparams, tcfg, _t(tokens), pad=8)
        S = jcfg.sliding_window or T + 8
        assert tc["stages"][0]["kv"][0].shape == (tcfg.n_layers, 1, S,
                                                  tcfg.n_kv_heads,
                                                  tcfg.head_dim)
        _close(tl, jl, LOGIT_TOL)
        _tree_close(tc, jc, lambda g, w: _close_scaled(g, w, HIDDEN_TOL))
        for i, tok in enumerate(follow):
            jl, jc = jax_decode_step(jparams, jcfg,
                                     jnp.asarray(tok, jnp.int32), jc,
                                     jnp.int32(T + i))
            tl, tc = TM.decode_step(tparams, tcfg, _t(tok), tc, T + i)
            _close(tl, jl, LOGIT_TOL)
        _tree_close(tc, jc, lambda g, w: _close_scaled(g, w, HIDDEN_TOL))


def test_rolling_cache_decode_equals_windowed_forward():
    """``tests/test_models.py::test_sliding_window_rolling_cache`` on the
    port: a prefill of 70 tokens past the 64-token window, then decode steps
    to 80 on the rolling cache, give the full forward's logits under the
    windowed mask; the cache keeps its 64 slots throughout."""
    jcfg, tcfg, _, _ = _setup("mixtral_8x22b")
    W = tcfg.sliding_window
    assert W == 64
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    p = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                         device="cpu")
    T, k = 80, 70
    toks = _t(np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, T)))
    h, _ = TM.forward_hidden(p, tcfg, toks)
    full = TM.lm_logits(p, tcfg, h)
    logits, cache = TM.prefill(p, tcfg, toks[:, :k])
    _close(logits, full[:, k - 1], ROLLING_TOL)
    for i in range(k, T):
        logits, cache = TM.decode_step(p, tcfg, toks[:, i], cache, i)
        _close(logits, full[:, i], ROLLING_TOL)
    assert cache["stages"][0]["kv"][0].shape[2] == W


def test_rolling_decode_per_row_cache_lengths():
    """Continuous batching on a rolling cache: a per-row ``[B]`` cache_len
    (one row past the window, one not) writes slot ``cache_len % W`` of its
    own row, as JAX's row scatter does."""
    jcfg, tcfg, jparams, tparams = _setup("mixtral_8x22b")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["stages"][0]["attn"].items()}
    rng = np.random.default_rng(2)
    W = tcfg.sliding_window
    shape = (2, W, tcfg.n_kv_heads, tcfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    lens = np.array([150, 20], np.int32)
    jo, (jk, jv) = JA.attn_decode(jp, jcfg, jnp.asarray(x),
                                  (jnp.asarray(kc), jnp.asarray(vc)),
                                  cache_len=jnp.asarray(lens), rolling=True)
    to, (tk, tv) = TA.attn_decode(tp, tcfg, _t(x), (_t(kc).clone(),
                                                     _t(vc).clone()),
                                  cache_len=_t(lens).long(), rolling=True)
    _close_scaled(to, jo, HIDDEN_TOL)
    _close_scaled(tk, jk, HIDDEN_TOL)
    _close_scaled(tv, jv, HIDDEN_TOL)
    changed = (tk != _t(kc)).any(dim=-1).any(dim=-1)
    assert changed[0].nonzero().flatten().tolist() == [150 % W]
    assert changed[1].nonzero().flatten().tolist() == [20]


# --------------------------------------------------------------------------
# serving and the loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    """Both engines (2 slots, prompts of 5, 70 and 100 tokens: mixtral's
    window wraps in prefill, and every request decodes past it, or beside
    a row that does) give the same greedy tokens."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 70, 100)]
    jeng = JaxServeEngine(jcfg, jparams, slots=2, max_seq=128)
    teng = ServeEngine(tcfg, tparams, slots=2, max_seq=128, device="cpu")
    jrids = [jeng.submit(p, max_new=6) for p in prompts]
    trids = [teng.submit(p, max_new=6) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    want = [jdone[r].tokens for r in jrids]
    assert [tdone[r].tokens for r in trids] == want
    assert all(len(t) == 6 for t in want)
    assert teng.stats["prefills"] == 3
    assert teng.cache["stages"][0]["kv"][0].shape[2] == (
        jcfg.sliding_window or 128)


def test_forward_loss_includes_the_moe_aux():
    """Reduced moonshot's ``forward_loss`` is ``nll + aux`` with the MoE
    balance loss of every block summed, both against JAX's."""
    jcfg, tcfg, jparams, tparams = _setup("moonshot_v1_16b_a3b")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = tokens.copy()
    labels[0, :3] = -1
    jloss, jm = JM.forward_loss(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                                "labels": jnp.asarray(labels)})
    tloss, tm = TM.forward_loss(tparams, tcfg, {"tokens": _t(tokens),
                                                "labels": _t(labels)})
    assert float(tm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tloss) == pytest.approx(float(tm["nll"] + tm["aux"]))


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2-1.5b",
                                  "moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_serve_cli_serves_the_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id>`` through the
    registry (its reduced config, fp32), on the CPU."""
    serve_cli.main(["--arch", arch, "--requests", "3", "--slots", "2",
                    "--max-seq", "32", "--max-new", "3", "--device", "cpu"])
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out

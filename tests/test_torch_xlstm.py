"""The port's xLSTM path against the JAX package's, on the CPU.

Reduced xlstm-1.3b (8 blocks: 7 mLSTM + 1 sLSTM, d_model 128, 4 heads) in
fp32; the JAX package's own initialised weights are carried across by
``repro_torch.convert``, inputs are numpy arrays from a seed. On CPU tensors
the port's ``ssd_scan`` and ``slstm_scan`` wrappers run their plain versions
(sequential scans), while the JAX side runs its chunked SSD and its
``lax.scan`` over ``_slstm_cell``: the same math in another summation order.

Tolerances: engine-level primitives (conv, decode steps, group norm) 2e-5;
one block's mixer, prefill state and decode step 1e-4 (fp32 through a
recurrence and a few projections). Through the whole 8-block model, hidden
states and caches within 1e-4 of the tensor's largest magnitude: each block
adds ~1e-6 of summation noise and the per-head group norm amplifies it where
a head's spread is small, so single elements near zero drift by more than
1e-4 of themselves. bf16 logits 1e-2, about one bf16 ulp at the logits'
magnitude here (|logit| < 2, ulp <= 2^-7).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import xlstm as TX
from repro_torch.serve.engine import ServeEngine

PRIM_TOL = 2e-5
HIDDEN_TOL = 1e-4
LOGIT_TOL = 1e-2
MARGIN = 1e-2           # top-2 logit gap every greedy step must keep

# JAX's decode step compiled once for the module (eager, each call takes ~1 s)
jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("xlstm_1_3b").reduced(),
                               param_dtype="float32", remat="none")
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol):
    """max |got - want| <= tol * max |want| (whole-model tensors)."""
    want = _np(want)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mixer(tree, stage: int):
    """Layer 0 mixer params of ``stage`` (0: mLSTM, 1: sLSTM), both sides."""
    return jax.tree_util.tree_map(lambda x: x[0], tree["stages"][stage])


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_config_matches_jax():
    want = ArchConfig(**dataclasses.asdict(jax_get_config("xlstm_1_3b")))
    cfg = get_config("xlstm-1.3b")
    assert cfg == want == get_config("xlstm_1_3b")
    assert cfg.reduced() == ArchConfig(
        **dataclasses.asdict(jax_get_config("xlstm_1_3b").reduced()))
    assert cfg.block_pattern == (("mlstm",) * 7 + ("slstm",)) * 6
    assert TX.mlstm_dims(cfg) == JX.mlstm_dims(cfg) == (4096, 4, 512, 1024)
    assert TX.slstm_ff_dim(cfg.d_model) == 5504


def test_init_params_tree_matches_jax(setup):
    """Same key paths, shapes and dtypes as the JAX package's params."""
    jcfg, tcfg, jparams, _ = setup
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(convert.to_numpy(mine))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path


def test_convert_round_trip_of_xlstm_params(setup):
    """Nested mixer dicts cross unchanged: paths, dtypes and bits (bf16)."""
    jparams = setup[2]
    jtree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jnp.bfloat16) if a.ndim > 2
        else np.asarray(a), jparams)
    ttree = convert.to_torch(jtree, device="cpu")
    assert ttree["stages"][1]["mixer"]["r"].dtype == torch.bfloat16
    assert ttree["stages"][0]["mixer"]["b_f"].dtype == torch.float32
    assert ttree["stages"][0]["mixer"]["wq"].shape == (7, 256, 4, 32)
    back = convert.to_numpy(ttree)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
def test_group_norm_conv_and_decode_steps():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 9, 4, 32)
    g = 1 + _rand(rng, 32, scale=0.1)
    _close(TC.group_norm_heads(_t(x), _t(g), 1e-6),
           JC.group_norm_heads(jnp.asarray(x), jnp.asarray(g), 1e-6), PRIM_TOL)
    xs, w, b = _rand(rng, 2, 9, 24), _rand(rng, 24, 4), _rand(rng, 24)
    _close(TS.causal_conv1d(_t(xs), _t(w), _t(b)),
           JS.causal_conv1d(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(b)),
           PRIM_TOL)
    st, xt = _rand(rng, 2, 3, 24), _rand(rng, 2, 1, 24)
    got = TS.conv_decode_step(_t(st), _t(xt), _t(w), _t(b))
    want = JS.conv_decode_step(jnp.asarray(st), jnp.asarray(xt), jnp.asarray(w),
                               jnp.asarray(b))
    for g_, w_ in zip(got, want):
        _close(g_, w_, PRIM_TOL)
    S, x1, a1 = _rand(rng, 2, 4, 8, 16), _rand(rng, 2, 4, 16), -np.abs(
        _rand(rng, 2, 4, scale=0.3))
    B1, C1, Sn, w1 = (_rand(rng, 2, 4, 8), _rand(rng, 2, 4, 8),
                      _rand(rng, 2, 4, 8), _rand(rng, 2, 4))
    got = TS.ssd_decode_step(_t(S), _t(x1), _t(a1), _t(B1), _t(C1))
    want = JS.ssd_decode_step(*map(jnp.asarray, (S, x1, a1, B1, C1)))
    got += TS.ssd_decode_norm_step(_t(Sn), _t(w1), _t(a1), _t(B1), _t(C1))
    want += JS.ssd_decode_norm_step(*map(jnp.asarray, (Sn, w1, a1, B1, C1)))
    for g_, w_ in zip(got, want):
        _close(g_, w_, PRIM_TOL)


@pytest.mark.parametrize("T,chunk,G", [(64, 16, 1), (48, 48, 2)])
def test_ssd_chunked_and_scan_ref_vs_jax(T, chunk, G):
    """The port's plain chunked form and its sequential form (groups
    broadcast to heads) against JAX's, with an initial state."""
    rng = np.random.default_rng(T)
    b, H, N, P = 2, 4, 8, 16
    x, a = _rand(rng, b, T, H, P, scale=0.5), -np.abs(_rand(rng, b, T, H,
                                                            scale=0.3))
    Bm, Cm = _rand(rng, b, T, G, N, scale=0.5), _rand(rng, b, T, G, N,
                                                      scale=0.5)
    S0 = _rand(rng, b, H, N, P)
    want = JS.ssd_chunked(*map(jnp.asarray, (x, a, Bm, Cm)), chunk,
                          initial_state=jnp.asarray(S0))
    got = TS.ssd_chunked(*map(_t, (x, a, Bm, Cm)), chunk, initial_state=_t(S0))
    seq = TS.ssd_scan_ref(*map(_t, (x, a, Bm, Cm)), initial_state=_t(S0))
    for g_, s_, w_ in zip(got, seq, want):
        _close(g_, w_, HIDDEN_TOL)
        _close(s_, w_, HIDDEN_TOL)


# --------------------------------------------------------------------------
# mixers and recurrent prefills
# --------------------------------------------------------------------------
def _check_decode(jdec, tdec, jp, tp, jcfg, tcfg, jc, rng):
    """One decode step from the JAX prefill's state, both sides."""
    x1 = _rand(rng, 2, 1, 128)
    tc = convert.to_torch(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    jout, jnew = jdec(jp, jcfg, jnp.asarray(x1), jc)
    tout, tnew = tdec(tp, tcfg, _t(x1), tc)
    _close(tout, jout, HIDDEN_TOL)
    for k in jnew:
        _close(tnew[k], jnew[k], HIDDEN_TOL)


@pytest.mark.parametrize("T", [16, 1])
def test_mlstm_forward_prefill_decode(setup, T):
    jcfg, tcfg, jparams, tparams = setup
    jp = _mixer(jparams, 0)["mixer"]
    tp = TC.tree_map(lambda t: t[0], tparams["stages"][0])["mixer"]
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, T, 128)
    if T > 1:   # JAX's forward takes T <= 256 or a multiple of 256
        _close(TX.mlstm_forward(tp, tcfg, _t(x)),
               JX.mlstm_forward(jp, jcfg, jnp.asarray(x)), HIDDEN_TOL)
    jout, jc = JB._recurrent_prefill_mlstm(jp, jcfg, jnp.asarray(x))
    tout, tc = TB._recurrent_prefill_mlstm(tp, tcfg, _t(x))
    _close(tout, jout, HIDDEN_TOL)
    for k in ("ssm", "ssm_n"):
        _close(tc[k], jc[k], HIDDEN_TOL)
    K1 = tcfg.ssm_conv - 1
    assert tc["conv"].shape == (2, K1, 256)
    # JAX keeps only the T rows it has; the port pads the rest with zeros
    _close(tc["conv"][:, K1 - min(T, K1):], jc["conv"], HIDDEN_TOL)
    assert not tc["conv"][:, :K1 - min(T, K1)].any()
    if T >= K1:
        _check_decode(JX.mlstm_decode, TX.mlstm_decode, jp, tp, jcfg, tcfg,
                      jc, rng)


@pytest.mark.parametrize("T", [16, 1])
def test_slstm_forward_prefill_decode(setup, T):
    jcfg, tcfg, jparams, tparams = setup
    jp = _mixer(jparams, 1)["mixer"]
    tp = TC.tree_map(lambda t: t[0], tparams["stages"][1])["mixer"]
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, T, 128)
    _close(TX.slstm_forward(tp, tcfg, _t(x)),
           JX.slstm_forward(jp, jcfg, jnp.asarray(x)), HIDDEN_TOL)
    jout, jc = JB._recurrent_prefill_slstm(jp, jcfg, jnp.asarray(x))
    tout, tc = TB._recurrent_prefill_slstm(tp, tcfg, _t(x))
    _close(tout, jout, HIDDEN_TOL)
    for k in ("c", "n", "m", "h"):
        _close(tc[k], jc[k], HIDDEN_TOL)
    _check_decode(JX.slstm_decode, TX.slstm_decode, jp, tp, jcfg, tcfg, jc,
                  rng)


# --------------------------------------------------------------------------
# the whole model and the engine
# --------------------------------------------------------------------------
def test_forward_hidden(setup):
    jcfg, tcfg, jparams, tparams = setup
    tokens = np.random.default_rng(4).integers(0, 256, (2, 16))
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    th, _ = TM.forward_hidden(tparams, tcfg, _t(tokens))
    _close_scaled(th, jh, HIDDEN_TOL)


def test_prefill_and_decode_logits(setup):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 13))
    follow = rng.integers(0, 256, (4, 2))
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), pad=8)
    tl, tc = TM.prefill(tparams, tcfg, _t(tokens), pad=8)
    assert tl.dtype == torch.bfloat16 and tl.shape == (2, 256)
    _close(tl, jl, LOGIT_TOL)
    for i, tok in enumerate(follow):
        n = 13 + i
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                 jc, jnp.int32(n))
        tl, tc = TM.decode_step(tparams, tcfg, _t(tok), tc, n)
        _close(tl, jl, LOGIT_TOL)
    for stage, (jst, tst) in enumerate(zip(jc["stages"], tc["stages"])):
        for k in jst:
            _close_scaled(tst[k], jst[k], HIDDEN_TOL)


def test_short_prompt_prefill_then_decode_equals_forward(setup):
    """Prompts shorter than the conv window: prefill + decode gives the
    hidden state of a full forward over the same tokens."""
    _, tcfg, _, tparams = setup
    tokens = torch.tensor([[17, 4, 250, 9]])
    hidden, _ = TM.forward_hidden(tparams, tcfg, tokens)
    want = TM.lm_logits(tparams, tcfg, hidden[:, -1:])[:, 0]
    _, cache = TM.prefill(tparams, tcfg, tokens[:, :1])
    for i in (1, 2, 3):
        logits, cache = TM.decode_step(tparams, tcfg, tokens[:, i], cache, i)
    _close(logits, want.float(), LOGIT_TOL)


def _jax_greedy(jcfg, jparams, prompt, max_new):
    """tests/test_serve.py's reference_generate, with a top-2 margin check
    at every step so that bf16 rounding cannot flip a near tie."""
    logits, cache = JM.prefill(jparams, jcfg,
                               jnp.asarray(prompt, jnp.int32)[None],
                               pad=max_new + 4)
    out, pos = [], len(prompt)
    while True:
        top2 = np.sort(_np(logits[0]))[-2:]
        assert top2[1] - top2[0] > MARGIN, (out, top2)
        out.append(int(jnp.argmax(logits[0])))
        if len(out) == max_new:
            return out
        logits, cache = jax_decode_step(jparams, jcfg,
                                        jnp.asarray([out[-1]], jnp.int32),
                                        cache, jnp.int32(pos))
        pos += 1


def test_engine_greedy_tokens_equal_jax(setup):
    """Continuous batching over recurrent caches (3 requests, 2 slots) gives
    JAX's greedy tokens (as tests/test_serve.py::test_engine_recurrent_archs
    holds the JAX engine to them)."""
    jcfg, tcfg, jparams, tparams = setup
    prompts = [[5, 6, 7, 8], [200, 3, 3, 41, 9, 12], [77, 1, 130]]
    wants = [_jax_greedy(jcfg, jparams, p, 5) for p in prompts]
    eng = ServeEngine(tcfg, tparams, slots=2, max_seq=64, device="cpu")
    rids = [eng.submit(np.asarray(p), max_new=5) for p in prompts]
    done = eng.run()
    assert [done[r].tokens for r in rids] == wants
    assert eng.stats["prefills"] == 3

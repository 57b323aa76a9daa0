"""The port's zamba2 path against the JAX package's, on the CPU.

Reduced zamba2-2.7b (4 Mamba-2 layers, the shared ATTN block after every 2,
so 2 applications; d_model 128, hd 32, ssm_state N=16, ssm_head_dim P=32)
in fp32, and the same at head_dim 80, the full model's shared-block head
dim. The JAX package's own initialised weights are carried across by
``repro_torch.convert``; inputs are numpy arrays from a seed. On CPU
tensors the port's ``ssd_scan`` and ``flash_attention`` wrappers run their
plain versions (a sequential scan, exact softmax); the JAX side runs its
chunked SSD (or its sequential oracle where T is not a multiple of its
chunk) and its chunked attention: the same math in another summation
order.

Tolerances: the Mamba-2 mixer, its prefill states and decode steps within
2e-5 (as |got - want| <= tol + tol * |want|: fp32 through a recurrence and
a few projections). Through the whole model, hidden states and caches
within 1e-5 of the tensor's largest magnitude. bf16 logits 1e-2, about one
bf16 ulp at the logits' magnitude here (|logit| < 2, ulp <= 2^-7).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.kernels import flash_attention_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serve.engine import ServeEngine

MIXER_TOL = 2e-5
HIDDEN_TOL = 1e-5
LOGIT_TOL = 1e-2
MARGIN = 1e-2           # top-2 logit gap every greedy step must keep
HEAD_DIMS = [32, 80]    # the reduced config's, the full model's

# JAX's decode step compiled once for the module (eager, each call takes ~1 s)
jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)


def _cfgs(head_dim: int = 32):
    jcfg = dataclasses.replace(jax_get_config("zamba2_2_7b").reduced(),
                               param_dtype="float32", remat="none",
                               head_dim=head_dim)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


_SETUPS = {}


def _setup(head_dim: int):
    """(jcfg, tcfg, jparams, tparams), built once per head dim."""
    if head_dim not in _SETUPS:
        jcfg, tcfg = _cfgs(head_dim)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
        _SETUPS[head_dim] = jcfg, tcfg, jparams, tparams
    return _SETUPS[head_dim]


@pytest.fixture(scope="module", params=HEAD_DIMS, ids=lambda hd: f"hd{hd}")
def setup(request):
    return _setup(request.param)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol):
    """max |got - want| <= tol * max |want| (whole-model tensors)."""
    want = _np(want)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tree_close(got, want, check):
    """Every leaf of two trees with the same key paths (``got`` a tensor
    tree, ``want`` a JAX tree)."""
    gl = jax.tree_util.tree_leaves_with_path(convert.to_numpy(got))
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape, path
        check(torch.from_numpy(g), w)


# --------------------------------------------------------------------------
# config and params
# --------------------------------------------------------------------------
def test_config_matches_jax():
    """The config and the reduced config field for field; the Mamba-2 dims
    and the shared block's applications as the JAX package counts them."""
    want = ArchConfig(**dataclasses.asdict(jax_get_config("zamba2_2_7b")))
    cfg = get_config("zamba2-2.7b")
    assert cfg == want == get_config("zamba2_2_7b")
    assert cfg.reduced() == ArchConfig(
        **dataclasses.asdict(jax_get_config("zamba2_2_7b").reduced()))
    assert cfg.block_pattern == ("mamba2",) * 54 and cfg.head_dim == 80
    assert TS.mamba2_dims(cfg) == JS.mamba2_dims(cfg) == (5120, 80, 5248)
    assert TM.n_shared_applications(cfg) == JM.n_shared_applications(cfg) == 9
    assert TM.pattern_stages(cfg) == JM.pattern_stages(cfg) == [("mamba2",
                                                                 6)] * 9
    red = cfg.reduced()
    assert TS.mamba2_dims(red) == JS.mamba2_dims(red) == (256, 8, 288)
    assert TM.n_shared_applications(red) == JM.n_shared_applications(red) == 2


def test_init_params_tree_matches_jax(setup):
    """Same key paths, shapes and dtypes as the JAX package's params, the
    unstacked shared block included, and the same deterministic leaves
    (A_log = log(1..H) to within an fp32 ulp, D, norms, conv bias)."""
    jcfg, tcfg, jparams, _ = setup
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(convert.to_numpy(mine))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert mine["shared"]["attn"]["wq"].shape == (128, 4 * tcfg.head_dim)
    mixer = mine["stages"][0]["mixer"]
    jmixer = jparams["stages"][0]["mixer"]
    for key in ("A_log", "D", "norm", "conv_b"):
        np.testing.assert_allclose(mixer[key].numpy(), _np(jmixer[key]),
                                   rtol=2**-23, atol=0)
    dt0 = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt0 > 0.999e-3) & (dt0 < 0.1001)).all())


def test_bf16_params_keep_the_ssm_scalars_in_fp32():
    """A_log, D and dt_bias stay fp32 in a bf16 model, as in JAX, and
    ``convert`` carries them bit-exact."""
    jcfg = jax_get_config("zamba2_2_7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    mixer, jmixer = tparams["stages"][1]["mixer"], jparams["stages"][1]["mixer"]
    for key in ("A_log", "D", "dt_bias"):
        assert mixer[key].dtype == torch.float32
        assert mixer[key].numpy().tobytes() == np.asarray(
            jmixer[key]).tobytes()
    assert mixer["w_x"].dtype == torch.bfloat16
    mine = TM.init_params(ArchConfig(**dataclasses.asdict(jcfg)),
                          torch.Generator().manual_seed(0), device="cpu")
    assert mine["stages"][0]["mixer"]["dt_bias"].dtype == torch.float32
    assert mine["shared"]["ln1"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the Mamba-2 block
# --------------------------------------------------------------------------
def _mixer(jparams, tparams):
    """Layer 1 of stage 0's mixer params, both sides."""
    jp = jax.tree_util.tree_map(lambda x: x[1], jparams["stages"][0])["mixer"]
    tp = TC.tree_map(lambda t: t[1], tparams["stages"][0])["mixer"]
    return jp, tp


@pytest.mark.parametrize("T", [1, 2, 64, 137])
def test_mamba2_forward_prefill_decode(T):
    """Forward, prefill (output, conv and ssm states) and three decode steps
    from the prefill's state. Below the conv window (T < 3) JAX keeps only
    the T rows it has; the port pads the rest with zeros on the left, the
    causal conv's own padding, and JAX's decode runs from that padded state
    (its own would fail on the shapes)."""
    jcfg, tcfg, jparams, tparams = _setup(32)
    jp, tp = _mixer(jparams, tparams)
    rng = np.random.default_rng(T)
    x = _rand(rng, 2, T, 128)
    _close(TS.mamba2_forward(tp, tcfg, _t(x)),
           JS.mamba2_forward(jp, jcfg, jnp.asarray(x)), MIXER_TOL)
    jout, jc = JB._recurrent_prefill_mamba2(jp, jcfg, jnp.asarray(x))
    tout, tc = TB._recurrent_prefill_mamba2(tp, tcfg, _t(x))
    _close(tout, jout, MIXER_TOL)
    _close(tc["ssm"], jc["ssm"], MIXER_TOL)
    K1 = tcfg.ssm_conv - 1
    kept = min(T, K1)
    assert tc["conv"].shape == (2, K1, 288)
    _close(tc["conv"][:, K1 - kept:], jc["conv"], MIXER_TOL)
    assert not tc["conv"][:, :K1 - kept].any()
    jc = {"conv": jnp.pad(jc["conv"], ((0, 0), (K1 - kept, 0), (0, 0))),
          "ssm": jc["ssm"]}
    for _ in range(3):
        x1 = _rand(rng, 2, 1, 128)
        jy, jc = JS.mamba2_decode(jp, jcfg, jnp.asarray(x1), jc)
        ty, tc = TS.mamba2_decode(tp, tcfg, _t(x1), tc)
        _close(ty, jy, MIXER_TOL)
        for key in ("conv", "ssm"):
            _close(tc[key], jc[key], MIXER_TOL)


def test_mamba2_prefill_state_continues_as_the_forward():
    """Prefill on the first 5 tokens, then one decode step per token, gives
    the forward over all 9 tokens (the conv and ssm states carry exactly
    what the sequence needs)."""
    _, tcfg, jparams, tparams = _setup(32)
    _, tp = _mixer(jparams, tparams)
    x = _t(_rand(np.random.default_rng(9), 1, 9, 128))
    want = TS.mamba2_forward(tp, tcfg, x)
    y, cache = TB._recurrent_prefill_mamba2(tp, tcfg, x[:, :5])
    outs = [y]
    for t in range(5, 9):
        y, cache = TS.mamba2_decode(tp, tcfg, x[:, t:t + 1], cache)
        outs.append(y)
    _close(torch.cat(outs, dim=1), want.numpy(), MIXER_TOL)


# --------------------------------------------------------------------------
# the whole model: forward, prefill, decode, engine
# --------------------------------------------------------------------------
def test_forward_hidden(setup):
    jcfg, tcfg, jparams, tparams = setup
    tokens = np.random.default_rng(4).integers(0, 256, (2, 16))
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    th, aux = TM.forward_hidden(tparams, tcfg, _t(tokens))
    _close_scaled(th, jh, HIDDEN_TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_logits(setup):
    """Prefill logits and four decode steps against JAX's ``prefill`` and
    ``decode_step``; the caches after them, stages and the shared block's
    per-application KV (``[n_app, B, S, KV, hd]``), leaf for leaf."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 13))
    follow = rng.integers(0, 256, (4, 2))
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), pad=8)
    tl, tc = TM.prefill(tparams, tcfg, _t(tokens), pad=8)
    assert tl.dtype == torch.bfloat16 and tl.shape == (2, 256)
    assert tc["shared"]["kv"][0].shape == (2, 2, 21, 4, tcfg.head_dim)
    _close(tl, jl, LOGIT_TOL)
    for i, tok in enumerate(follow):
        n = 13 + i
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                 jc, jnp.int32(n))
        tl, tc = TM.decode_step(tparams, tcfg, _t(tok), tc, n)
        _close(tl, jl, LOGIT_TOL)
    _tree_close(tc, jc, lambda g, w: _close_scaled(g, w, HIDDEN_TOL))


def test_prefill_then_decode_equals_forward(setup):
    """The port against itself: prefill on a prefix (2 tokens, shorter than
    the conv window, and 7), then decode steps, gives the logits of a full
    forward over the same tokens; decode writes through views into the
    shared block's cache (the tensors the cache dict holds)."""
    _, tcfg, _, tparams = setup
    tokens = torch.tensor([[17, 4, 250, 9, 31, 8, 200, 77, 5, 64]])
    hidden, _ = TM.forward_hidden(tparams, tcfg, tokens)
    want = TM.lm_logits(tparams, tcfg, hidden)[0]
    for cut in (2, 7):
        logits, cache = TM.prefill(tparams, tcfg, tokens[:, :cut])
        k_shared = cache["shared"]["kv"][0]
        got = [logits[0]]
        for i in range(cut, tokens.shape[1]):
            logits, cache = TM.decode_step(tparams, tcfg, tokens[:, i],
                                           cache, i)
            got.append(logits[0])
        assert cache["shared"]["kv"][0] is k_shared
        assert k_shared[:, 0, tokens.shape[1] - 1].abs().sum() > 0
        _close(torch.stack(got), want[cut - 1:].float().numpy(), LOGIT_TOL)


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


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_engine_greedy_tokens_equal_jax(head_dim):
    """Continuous batching over zamba2's caches (2 requests of different
    lengths decoding side by side in 2 slots: the Mamba-2 states and the
    shared block's per-application KV go through the slot pool) gives JAX's
    greedy tokens, as tests/test_serve.py::test_engine_recurrent_archs holds
    the JAX engine to them, with that test's weights (PRNGKey(2)) and
    prompt. Every JAX step keeps a top-2 gap above ``MARGIN``: where two
    bf16 logits tie, the greedy token is not defined by the model."""
    jcfg, tcfg = _cfgs(head_dim)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    prompts = [[5, 6, 7, 8], [200, 3, 3, 41, 9, 12]]
    wants = [_jax_greedy(jcfg, jparams, p, 5) for p in prompts]
    eng = ServeEngine(tcfg, tparams, slots=2, max_seq=64, device="cpu")
    rids = [eng.submit(np.asarray(p), max_new=5) for p in prompts]
    done = eng.run()
    assert [done[r].tokens for r in rids] == wants
    assert eng.stats["prefills"] == 2 and eng.stats["decode_steps"] == 4


def test_serve_cli_serves_zamba2(capsys):
    """``python -m repro_torch.launch.serve --arch zamba2-2.7b`` through the
    registry (its reduced config, fp32), on the CPU."""
    serve_cli.main(["--arch", "zamba2-2.7b", "--requests", "3", "--slots",
                    "2", "--max-seq", "32", "--max-new", "3", "--device",
                    "cpu"])
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


# --------------------------------------------------------------------------
# flash attention at head_dim 80
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_flash_plain_hd80_vs_pallas(causal, window, dtype):
    """The plain version at the shared block's head dim against the JAX
    package's Pallas kernel in interpret mode (its block spans the full
    head dim), GQA 2:1."""
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal((1, 256, H, 80)).astype(np.float32)
               for H in (4, 2, 2))
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=128,
                     block_k=128, interpret=True)
    got = flash_attention_ref(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    _close(got, want, tol)

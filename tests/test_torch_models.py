"""The port's model functions against the JAX package's, on the CPU.

Reduced qwen3-0.6b in fp32; the JAX package's own initialised weights are
carried across by ``repro_torch.convert``, inputs are numpy arrays from a
seed. The JAX side runs attention through the Pallas kernel in interpret
mode (T divides its block: ``block_q = min(128, T)``); the port's side runs
the plain versions of its kernels (CPU tensors).

Tolerances: hidden states and fp32 activations 1e-4 (same math in another
summation order, through 4 layers); bf16 logits 1e-2, about one bf16 ulp at
the logits' magnitude here (|logit| < 2, ulp <= 2^-7).
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
from repro.models import common as JC
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM

HIDDEN_TOL = 1e-4
LOGIT_TOL = 1e-2


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_get_config("qwen3_0_6b").reduced(),
                               param_dtype="float32", remat="none",
                               attn_impl="pallas", **kw)
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


def _layer0(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def test_config_matches_jax_and_other_archs_raise():
    """Every ported arch's config, full and reduced, equals the JAX
    package's field for field (by id and by dashed name), nemotron-4-340b
    (the last of the ten) too; a name outside the registry raises."""
    want = ArchConfig(**dataclasses.asdict(jax_get_config("qwen3_0_6b")))
    assert get_config("qwen3-0.6b") == want == get_config("qwen3_0_6b")
    for arch in ("qwen3_0_6b", "qwen3_14b", "qwen2_1_5b",
                 "moonshot_v1_16b_a3b", "mixtral_8x22b", "nemotron_4_340b"):
        jcfg = jax_get_config(arch)
        assert get_config(arch) == ArchConfig(**dataclasses.asdict(jcfg))
        assert get_config(jcfg.name) == get_config(arch)
        assert get_config(arch).reduced() == ArchConfig(
            **dataclasses.asdict(jcfg.reduced()))
    with pytest.raises(NotImplementedError, match="not in the registry"):
        get_config("nemotron_4_341b")


@pytest.mark.parametrize("arch,frontend", [("qwen2_vl_7b", True),
                                           ("whisper_small", True),
                                           ("nemotron_4_340b", False)])
def test_frontend_archs_registered(arch, frontend):
    """The last three archs ported, qwen2-vl-7b, whisper-small and
    nemotron-4-340b, equal the JAX configs (by id and by dashed name,
    ``reduced()`` too); the two frontend archs carry M-RoPE sections or an
    encoder, nemotron neither."""
    jcfg = jax_get_config(arch)
    assert bool(jcfg.mrope_sections or jcfg.enc_dec) == frontend
    assert get_config(arch) == ArchConfig(**dataclasses.asdict(jcfg))
    assert get_config(jcfg.name) == get_config(arch)
    assert get_config(arch).reduced() == ArchConfig(
        **dataclasses.asdict(jcfg.reduced()))


@pytest.mark.parametrize("T,S,q_offset,window", [(9, 9, 0, 0), (5, 12, 7, 4)])
def test_attend_naive(T, S, q_offset, window):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, T, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 32)).astype(np.float32)
    want = JA.attend_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, q_offset=q_offset)
    got = TA.attend_naive(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window,
                          q_offset=q_offset)
    _close(got, want, HIDDEN_TOL)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [40]])).astype(np.int32)
    _close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
           JC.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6), 2e-5)
    _close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), HIDDEN_TOL)


def test_attn_prefill(setup):
    jcfg, tcfg, jparams, tparams = setup
    jp = _layer0(jparams["stages"][0])["attn"]
    tp = TC.tree_map(lambda t: t[0], tparams["stages"][0])["attn"]
    x = np.random.default_rng(1).standard_normal((2, 16, 128)).astype(
        np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jout, (jk, jv) = JA.attn_prefill(jp, jcfg, jnp.asarray(x),
                                     pos=jnp.asarray(pos))
    tout, (tk, tv) = TA.attn_prefill(tp, tcfg, torch.from_numpy(x),
                                     pos=torch.from_numpy(pos))
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close(got, want, HIDDEN_TOL)


@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_attn_decode(setup, form):
    """Both cache_len forms: the dynamic-update-slice write (scalar, as
    reference_generate uses) and the per-row scatter (ServeEngine)."""
    jcfg, tcfg, jparams, tparams = setup
    jp = _layer0(jparams["stages"][0])["attn"]
    tp = TC.tree_map(lambda t: t[0], tparams["stages"][0])["attn"]
    rng = np.random.default_rng(2)
    B, S = 2, 24
    kc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    x = rng.standard_normal((B, 1, 128)).astype(np.float32)
    cl = 13 if form == "scalar" else np.array([13, 5], np.int32)
    jout, (jk, jv) = JA.attn_decode(jp, jcfg, jnp.asarray(x),
                                    (jnp.asarray(kc), jnp.asarray(vc)),
                                    cache_len=jnp.asarray(cl))
    t_cl = cl if form == "scalar" else torch.from_numpy(cl)
    tout, (tk, tv) = TA.attn_decode(tp, tcfg, torch.from_numpy(x),
                                    (torch.from_numpy(kc.copy()),
                                     torch.from_numpy(vc.copy())),
                                    cache_len=t_cl)
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close(got, want, HIDDEN_TOL)


@pytest.mark.parametrize("T,impl", [(16, "pallas"), (11, "naive")])
def test_forward_hidden(setup, T, impl):
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tokens = np.random.default_rng(3).integers(0, 256, (2, T))
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    th, _ = TM.forward_hidden(tparams, tcfg, torch.from_numpy(tokens))
    _close(th, jh, HIDDEN_TOL)


@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_prefill_and_decode_logits(setup, form):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 16))
    follow = rng.integers(0, 256, (3, 2))
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), pad=8)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(tokens), pad=8)
    assert tl.dtype == torch.bfloat16 and tl.shape == (2, 256)
    _close(tl, jl, LOGIT_TOL)
    for i, tok in enumerate(follow):
        n = 16 + i
        jlen = jnp.int32(n) if form == "scalar" else jnp.full((2,), n,
                                                               jnp.int32)
        tlen = n if form == "scalar" else torch.full((2,), n)
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                jc, jlen)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                tlen)
        _close(tl, jl, LOGIT_TOL)
    jk = jc["stages"][0]["kv"][0]
    _close(tc["stages"][0]["kv"][0], jk, HIDDEN_TOL)


def test_convert_round_trip_keeps_paths_dtypes_and_bits():
    jcfg = jax_get_config("qwen3_0_6b").reduced()      # bf16 params
    jtree = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(5)))
    ttree = convert.to_torch(jtree, device="cpu")
    assert ttree["stages"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert ttree["stages"][0]["attn"]["wq"].shape == (4, 128, 128)
    back = convert.to_numpy(ttree)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

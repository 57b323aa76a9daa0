"""The port's whisper-small (the encoder, cross attention, sinusoidal
absolute positions, the ungated tanh-GELU MLP) against the JAX package's,
on the CPU.

Reduced config in fp32 (4 decoder and 2 encoder layers, d_model 128, hd
32, ``enc_len`` 32). The JAX package's own initialised weights are carried
across by ``repro_torch.convert``, except the QKV biases of every attention
(the encoder's, the decoder's self and cross attentions): JAX initialises
them to zero, so the tests draw them from a numpy seed into both trees.
Frames and tokens are numpy arrays from a seed. The JAX side serves
through the model's own entry points (``prefill(..., frames=...)``, then
``decode_step``), as its engine cannot. On CPU tensors the port's kernels
run their plain versions.

Tolerances (``tests/test_torch_archs.py``'s): hidden states, the encoder's
output and caches (the cross attention's ``xkv`` included) within 1e-5 of
the tensor's largest magnitude (fp32, another summation order); the loss
within 1e-5 relative; bf16 logits 1e-2, about one bf16 ulp at the logits'
magnitude here (|logit| < 2). The activation against ``jax.nn.gelu`` within
1e-6 (the same tanh formula in fp32). The sinusoid tables at full width
(448 and 1500 positions), where an fp32 angle's rounding grows with the
position, against the float64 table within ``p_max * 2^-23``.
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
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from test_torch_vlm import (HIDDEN_TOL, LOGIT_TOL, LOSS_RTOL, _close,
                            _close_scaled, _np, _t, _tree_close,
                            with_random_biases)

GELU_TOL = 1e-6

jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)

_SETUP = {}


def _setup():
    """(jcfg, tcfg, jparams, tparams), built once."""
    if not _SETUP:
        jcfg = dataclasses.replace(jax_get_config("whisper_small").reduced(),
                                   param_dtype="float32", remat="none")
        tcfg = ArchConfig(**dataclasses.asdict(jcfg))
        jparams = with_random_biases(JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)),
                                     np.random.default_rng(9))
        tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
        _SETUP["w"] = jcfg, tcfg, jparams, tparams
    return _SETUP["w"]


def _frames(rng, B, cfg):
    return (0.02 * rng.standard_normal((B, cfg.enc_len, cfg.d_model))
            ).astype(np.float32)


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _tlayer(tree, i=0):
    return TC.tree_map(lambda t: t[i], tree)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------
def test_config_and_params_tree_match_jax():
    """The registry's config is JAX's (reduced too); the port's init has
    the JAX tree's key paths and shapes: cross attention (``ln_x``,
    ``xattn`` without qk-norm) in each decoder block, ``encoder`` stacked
    on a layer axis and ``enc_norm``; the MLP has no ``w_gate``."""
    jcfg, tcfg, jparams, _ = _setup()
    full = jax_get_config("whisper_small")
    assert get_config("whisper-small") == ArchConfig(
        **dataclasses.asdict(full))
    assert get_config("whisper_small").reduced() == ArchConfig(
        **dataclasses.asdict(full.reduced()))
    init = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: np.zeros(t.shape), init))[0]
    assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a))
                                                  for p, a in want]
    assert init["encoder"]["ln1"].shape == (tcfg.n_enc_layers, tcfg.d_model)
    assert "w_gate" not in init["stages"][0]["mlp"]


def test_sinusoids():
    """``sinusoidal_positions`` and ``sinusoid_at`` (a scalar and a [B]
    vector of positions) against JAX's ``sinusoidal_positions`` and
    ``_sinusoid_at`` at the reduced width; row p of the table is the row
    at position p."""
    n_pos, d = 32, 128
    got = TC.sinusoidal_positions(n_pos, d)
    _close_scaled(got, JC.sinusoidal_positions(n_pos, d), HIDDEN_TOL)
    for pos in (n_pos - 1, np.array([0, 7, n_pos - 1], np.int32)):
        at = TC.sinusoid_at(torch.as_tensor(pos), d)
        _close_scaled(at, JM._sinusoid_at(jnp.asarray(pos), d), HIDDEN_TOL)
        assert torch.equal(at, got[torch.as_tensor(pos)])


@pytest.mark.parametrize("n_pos", [448, 1500])
def test_sinusoids_at_full_width(n_pos):
    """At whisper's width (d 768) and its decoder's 448 / encoder's 1500
    positions, the fp32 angle p * inv carries inv's rounding (2^-24
    relative) times p, so the port and JAX each sit within
    ``p_max * 2^-23`` of the float64 table (and differ from each other by
    up to twice that, beyond 1e-5): both are held to that bound."""
    d, half = 768, 384
    inv = np.exp(-np.log(10000.0) / (half - 1) * np.arange(half))
    angles = np.arange(n_pos)[:, None] * inv
    exact = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    bound = (n_pos - 1) * 2.0 ** -23
    for table in (TC.sinusoidal_positions(n_pos, d),
                  JC.sinusoidal_positions(n_pos, d)):
        assert float(np.abs(_np(table) - exact).max()) <= bound


def test_gelu_is_jax_tanh_form():
    """``activation_fn("gelu")`` is ``jax.nn.gelu``'s default (tanh), and
    not torch's default erf form."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    got = TC.activation_fn("gelu")(_t(x))
    _close(got, jax.nn.gelu(jnp.asarray(x)), GELU_TOL)
    erf = torch.nn.functional.gelu(_t(x))
    assert float((erf - got).abs().max()) > 10 * GELU_TOL


def test_ungated_mlp():
    """A decoder layer's ungated MLP (``act(x @ w_up) @ w_down``)."""
    jcfg, tcfg, jparams, tparams = _setup()
    x = np.random.default_rng(1).standard_normal((2, 9, jcfg.d_model)
                                                 ).astype(np.float32)
    want = JMLP.mlp_forward(_layer(jparams["stages"][0]["mlp"]), jcfg,
                            jnp.asarray(x))
    got = TMLP.mlp_forward(_tlayer(tparams["stages"][0]["mlp"]), tcfg, _t(x))
    _close_scaled(got, want, HIDDEN_TOL)


def test_cross_attention():
    """A decoder layer's cross attention: ``attn_forward`` with ``kv_x``
    (T = 9 query rows against S = 32 frames, non-causal, no RoPE),
    ``cross_kv`` and ``attn_decode_cross`` on its (k, v)."""
    jcfg, tcfg, jparams, tparams = _setup()
    jp = _layer(jparams["stages"][0]["xattn"])
    tp = _tlayer(tparams["stages"][0]["xattn"])
    assert "q_norm" not in tp and "bq" in tp
    rng = np.random.default_rng(2)
    B, T = 2, 9
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)
                              ).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    want = JA.attn_forward(jp, jcfg, jnp.asarray(x), pos=jnp.asarray(pos),
                           causal=False, kv_x=jnp.asarray(enc),
                           use_rope=False)
    got = TA.attn_forward(tp, tcfg, _t(x), pos=_t(pos), causal=False,
                          kv_x=_t(enc), use_rope=False)
    _close_scaled(got, want, HIDDEN_TOL)
    jkv = JA.cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = TA.cross_kv(tp, tcfg, _t(enc))
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == (B, jcfg.enc_len, jcfg.n_kv_heads,
                                  jcfg.head_dim)
        _close_scaled(g, w, HIDDEN_TOL)
    xd = x[:, -1:]
    want = JA.attn_decode_cross(jp, jcfg, jnp.asarray(xd), jkv)
    got = TA.attn_decode_cross(tp, tcfg, _t(xd), tkv)
    _close_scaled(got, want, HIDDEN_TOL)
    # the decode form on the last row is the full pass's last row
    _close_scaled(got[:, 0], TA.attn_forward(
        tp, tcfg, _t(x), pos=_t(pos), causal=False, kv_x=_t(enc),
        use_rope=False)[:, -1], HIDDEN_TOL)


def test_encode():
    """``encode``: sinusoids on the frames, the non-causal encoder blocks
    and ``enc_norm``."""
    jcfg, tcfg, jparams, tparams = _setup()
    frames = _frames(np.random.default_rng(3), 2, jcfg)
    want = JM.encode(jparams, jcfg, jnp.asarray(frames))
    got = TM.encode(tparams, tcfg, _t(frames))
    assert got.shape == (2, jcfg.enc_len, jcfg.d_model)
    _close_scaled(got, want, HIDDEN_TOL)
    with pytest.raises(ValueError, match="frames"):
        TM.encode(tparams, tcfg, None)


def test_attention_calls_route_through_the_kernel(monkeypatch):
    """Every full-sequence attention of a prefill goes through
    ``ops.attention`` (the flash kernel on the card): each encoder layer's
    non-causal S = T = enc_len, then each decoder layer's causal self
    attention and non-causal cross attention (T rows against enc_len)."""
    jcfg, tcfg, _, tparams = _setup()
    calls = []
    attention = ops.attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", counted)
    rng = np.random.default_rng(4)
    tokens = _t(rng.integers(0, jcfg.vocab_size, (2, 7)))
    TM.prefill(tparams, tcfg, tokens, frames=_t(_frames(rng, 2, jcfg)))
    S = jcfg.enc_len
    assert calls == ([(S, S, False)] * jcfg.n_enc_layers
                     + [(7, 7, True), (7, S, False)] * jcfg.n_layers)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_forward_hidden_and_loss_with_frames():
    """``forward_hidden`` on JAX's encoder output and ``forward_loss`` with
    frames against JAX's; the frames move the loss."""
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(5)
    B, T = 2, 12
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = tokens.copy()
    labels[1, :4] = -1
    frames = _frames(rng, B, jcfg)
    enc = JM.encode(jparams, jcfg, jnp.asarray(frames))
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens), enc_out=enc)
    th, _ = TM.forward_hidden(tparams, tcfg, _t(tokens),
                              enc_out=_t(np.array(enc)))
    _close_scaled(th, jh, HIDDEN_TOL)
    jloss, jm = JM.forward_loss(jparams, jcfg, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "frames": jnp.asarray(frames)})
    tloss, tm = TM.forward_loss(tparams, tcfg, {
        "tokens": _t(tokens), "labels": _t(labels), "frames": _t(frames)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=LOSS_RTOL)
    other = TM.forward_loss(tparams, tcfg, {
        "tokens": _t(tokens), "labels": _t(labels),
        "frames": _t(frames[::-1].copy())})[0]
    assert abs(float(other) - float(tloss)) > 1e-5


def test_prefill_and_decode_steps():
    """``prefill`` of 8 tokens on 32 frames, then 4 ``decode_step``s (the
    sinusoid at ``cache_len`` added to each token): logits and every cache
    leaf (self ``kv`` and cross ``xkv``) against JAX's."""
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(6)
    B, T = 2, 8
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    frames = _frames(rng, B, jcfg)
    follow = rng.integers(0, jcfg.vocab_size, (4, B)).astype(np.int32)
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                        frames=jnp.asarray(frames), pad=6)
    tl, tc = TM.prefill(tparams, tcfg, _t(tokens), frames=_t(frames), pad=6)
    xk = tc["stages"][0]["xkv"][0]
    assert xk.shape == (jcfg.n_layers, B, jcfg.enc_len, jcfg.n_kv_heads,
                        jcfg.head_dim)
    _close(tl, jl, LOGIT_TOL)
    _tree_close(tc, jc, HIDDEN_TOL)
    for i, tok in enumerate(follow):
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                 jnp.int32(T + i))
        tl, tc = TM.decode_step(tparams, tcfg, _t(tok).long(), tc, T + i)
        _close(tl, jl, LOGIT_TOL)
    _tree_close(tc, jc, HIDDEN_TOL)
    cache = TM.init_cache(tcfg, B, 16, device="cpu")
    assert cache["stages"][0]["xkv"][0].shape == xk.shape

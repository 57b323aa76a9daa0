"""The port's qwen2-vl-7b (M-RoPE, the stub frontend's patch embeddings set
into the token stream) against the JAX package's, on the CPU.

Reduced config in fp32 (4 layers, d_model 128, hd 32, M-RoPE sections
(4, 6, 6)). The JAX package's own initialised weights are carried across by
``repro_torch.convert``, except the QKV biases: JAX initialises them to
zero, so the tests draw them from a numpy seed into both trees. Inputs are
numpy arrays from a seed; the M-RoPE ids follow Qwen2-VL's layout (text
before the image at t = h = w = i, the g x g grid at (s0, s0 + r, s0 + c),
text after it from s0 + g on), so the three axes differ. The JAX side
serves through the model's own entry points (``prefill`` with ``pos3`` and
the patches, then ``decode_step``), as its engine cannot; decode takes
``cache_len`` on all three axes on both sides. On CPU tensors the port's
kernels run their plain versions.

Tolerances (``tests/test_torch_archs.py``'s): hidden states, rotated
tensors and caches within 1e-5 of the tensor's largest magnitude (fp32,
another summation order); the loss within 1e-5 relative; bf16 logits 1e-2,
about one bf16 ulp at the logits' magnitude here (|logit| < 2).
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
from repro_torch.models.common import tree_leaves
from repro_torch.serve.engine import ServeEngine

LOGIT_TOL = 1e-2
HIDDEN_TOL = 1e-5
LOSS_RTOL = 1e-5
BIAS_STD = 0.5
GRID, GRID_AT = 2, 2        # a 2 x 2 grid of patches at positions 2-5

jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)


def with_random_biases(tree, rng):
    """``tree`` with every attention bias (bq, bk, bv) drawn N(0, BIAS_STD^2)."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(BIAS_STD * rng.standard_normal(v.shape),
                                jnp.float32)
                    if k in ("bq", "bk", "bv") else with_random_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_random_biases(v, rng) for v in tree)
    return tree


_SETUP = {}


def _setup():
    """(jcfg, tcfg, jparams, tparams), built once."""
    if not _SETUP:
        jcfg = dataclasses.replace(jax_get_config("qwen2_vl_7b").reduced(),
                                   param_dtype="float32", remat="none")
        tcfg = ArchConfig(**dataclasses.asdict(jcfg))
        jparams = with_random_biases(JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)),
                                     np.random.default_rng(9))
        tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
        _SETUP["v"] = jcfg, tcfg, jparams, tparams
    return _SETUP["v"]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_scaled(got, want, tol):
    scale = max(float(np.abs(_np(want)).max()), 1e-30)
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= tol * scale, (err, tol * scale)


def _tree_close(got, want, tol):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g, w, tol)


def vlm_pos3(B: int, T: int, start: int = GRID_AT, grid: int = GRID):
    """[3, B, T] int32 M-RoPE ids with one grid x grid image at ``start``:
    Qwen2-VL's rope index for a stub frontend."""
    t = np.empty((3, T), np.int64)
    t[:, :start] = np.arange(start)
    r, c = np.divmod(np.arange(grid * grid), grid)
    end = start + grid * grid
    t[:, start:end] = np.stack([np.full_like(r, start), start + r, start + c])
    t[:, end:] = start + grid + np.arange(T - end)
    return np.broadcast_to(t[:, None], (3, B, T)).astype(np.int32).copy()


def vlm_inputs(rng, B: int, T: int, d: int):
    """(patch_embeds [B, P, d] ~ N(0, 0.02^2), patch_pos [B, P], pos3)."""
    P = GRID * GRID
    patches = (0.02 * rng.standard_normal((B, P, d))).astype(np.float32)
    patch_pos = np.broadcast_to(np.arange(GRID_AT, GRID_AT + P),
                                (B, P)).astype(np.int32).copy()
    return patches, patch_pos, vlm_pos3(B, T)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------
def test_config_and_params_tree_match_jax():
    """The registry's config is JAX's; the port's init has the JAX tree's
    key paths and shapes (QKV biases, no encoder)."""
    jcfg, tcfg, jparams, _ = _setup()
    assert get_config("qwen2-vl-7b") == ArchConfig(
        **dataclasses.asdict(jax_get_config("qwen2_vl_7b")))
    init = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: np.zeros(t.shape), init))[0]
    assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a))
                                                  for p, a in want]


def test_apply_mrope_with_unequal_axes():
    """``apply_mrope`` against JAX's with t, h and w ids all different; with
    the three axes equal it is plain RoPE, bit for bit; sections that do
    not cover head_dim / 2 raise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos3 = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)
    assert (pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()
    for theta in (1e6, 1e4):
        got = TC.apply_mrope(_t(x), _t(pos3), theta, (4, 6, 6))
        want = JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                              (4, 6, 6))
        _close_scaled(got, want, HIDDEN_TOL)
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    assert torch.equal(TC.apply_mrope(_t(x), _t(same), 1e6, (4, 6, 6)),
                       TC.apply_rope(_t(x), _t(same[0]), 1e6))
    with pytest.raises(ValueError, match="sections"):
        TC.apply_mrope(_t(x), _t(pos3), 1e6, (4, 6, 4))


def test_pos3_layout():
    """The helper's ids: text, then the grid's (t, h, w), then text again
    from start + grid."""
    ids = vlm_pos3(1, 9)[:, 0]
    assert ids.tolist() == [[0, 1, 2, 2, 2, 2, 4, 5, 6],
                            [0, 1, 2, 2, 3, 3, 4, 5, 6],
                            [0, 1, 2, 3, 2, 3, 4, 5, 6]]


def test_embed_tokens_sets_the_patches():
    """Patch embeddings replace the token rows at ``patch_pos`` (the stub
    frontend), as JAX's ``embed_tokens``; no sinusoids (M-RoPE)."""
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    patches, patch_pos, _ = vlm_inputs(rng, 2, 9, jcfg.d_model)
    patch_pos[1] += 1                       # per-row positions
    got = TM.embed_tokens(tparams, tcfg, _t(tokens), _t(patches),
                          _t(patch_pos).long())
    want = JM.embed_tokens(jparams, jcfg, jnp.asarray(tokens),
                           jnp.asarray(patches), jnp.asarray(patch_pos))
    _close(got, want, 0)
    assert torch.equal(got[1, 3:7], _t(patches[1]))


def test_attention_with_pos3():
    """A layer's attention prefill with M-RoPE ids and a decode step after
    it (``cache_len`` on all three axes) against JAX's."""
    jcfg, tcfg, jparams, tparams = _setup()
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["stages"][0]["attn"].items()}
    rng = np.random.default_rng(1)
    B, T = 2, 9
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos3 = vlm_pos3(B, T)
    jout, (jk, jv) = JA.attn_prefill(jp, jcfg, jnp.asarray(x),
                                     pos=jnp.asarray(pos),
                                     pos3=jnp.asarray(pos3))
    tout, (tk, tv) = TA.attn_prefill(tp, tcfg, _t(x), pos=_t(pos),
                                     pos3=_t(pos3))
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close_scaled(got, want, HIDDEN_TOL)
    with pytest.raises(ValueError, match="pos3"):
        TA.attn_prefill(tp, tcfg, _t(x), pos=_t(pos))

    xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jcache = tuple(jnp.pad(a, ((0, 0), (0, 3), (0, 0), (0, 0)))
                   for a in (jk, jv))
    tcache = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3))
                   for t in (tk, tv))
    jd, jc = JA.attn_decode(jp, jcfg, jnp.asarray(xd), jcache, cache_len=T)
    td, tc = TA.attn_decode(tp, tcfg, _t(xd), tcache, cache_len=T)
    _close_scaled(td, jd, HIDDEN_TOL)
    _close_scaled(tc[0], jc[0], HIDDEN_TOL)
    _close_scaled(tc[1], jc[1], HIDDEN_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_forward_hidden_and_loss_with_patches():
    """``forward_hidden`` and ``forward_loss`` with patches and M-RoPE ids
    against JAX's; the patches move the loss."""
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(4)
    B, T = 2, 12
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = tokens.copy()
    labels[0, :3] = -1
    patches, patch_pos, pos3 = vlm_inputs(rng, B, T, jcfg.d_model)
    jh, _ = JM.forward_hidden(jparams, jcfg, jnp.asarray(tokens),
                              pos3=jnp.asarray(pos3),
                              patch_embeds=jnp.asarray(patches),
                              patch_pos=jnp.asarray(patch_pos))
    th, _ = TM.forward_hidden(tparams, tcfg, _t(tokens), pos3=_t(pos3),
                              patch_embeds=_t(patches),
                              patch_pos=_t(patch_pos).long())
    _close_scaled(th, jh, HIDDEN_TOL)
    jbatch = {"tokens": tokens, "labels": labels, "pos3": pos3,
              "patch_embeds": patches, "patch_pos": patch_pos}
    jloss, jm = JM.forward_loss(jparams, jcfg,
                                {k: jnp.asarray(v) for k, v in jbatch.items()})
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    tbatch["patch_pos"] = tbatch["patch_pos"].long()
    tloss, tm = TM.forward_loss(tparams, tcfg, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=LOSS_RTOL)
    no_patches = TM.forward_loss(tparams, tcfg, {
        k: v for k, v in tbatch.items() if k not in ("patch_embeds",
                                                     "patch_pos")})[0]
    assert abs(float(no_patches) - float(tloss)) > 1e-4


def test_prefill_and_decode_steps():
    """``prefill`` of 8 tokens with a 2 x 2 grid of patches at positions
    2-5 and its M-RoPE ids, then 4 ``decode_step``s at a scalar cache_len:
    logits and the caches, leaf for leaf, against JAX's."""
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(5)
    B, T = 2, 8
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    patches, patch_pos, pos3 = vlm_inputs(rng, B, T, jcfg.d_model)
    follow = rng.integers(0, jcfg.vocab_size, (4, B)).astype(np.int32)
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                        pos3=jnp.asarray(pos3),
                        patch_embeds=jnp.asarray(patches),
                        patch_pos=jnp.asarray(patch_pos), pad=6)
    tl, tc = TM.prefill(tparams, tcfg, _t(tokens), pos3=_t(pos3),
                        patch_embeds=_t(patches),
                        patch_pos=_t(patch_pos).long(), pad=6)
    _close(tl, jl, LOGIT_TOL)
    _tree_close(tc, jc, HIDDEN_TOL)
    for i, tok in enumerate(follow):
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                 jnp.int32(T + i))
        tl, tc = TM.decode_step(tparams, tcfg, _t(tok).long(), tc, T + i)
        _close(tl, jl, LOGIT_TOL)
    _tree_close(tc, jc, HIDDEN_TOL)


@pytest.mark.parametrize("arch,needs", [("qwen2-vl-7b", "pos3"),
                                        ("whisper-small", "frames")])
def test_serve_engine_raises(arch, needs):
    """The engine's requests carry tokens only, so it refuses an arch whose
    prefill needs frames or M-RoPE ids, naming the entry points to use."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError,
                       match=f"needs {needs}.*prefill.*decode_step"):
        ServeEngine(cfg, params, slots=2, max_seq=32, device="cpu")

"""nemotron-4-340b in the port against the JAX package, on the CPU: its
config, the squared-ReLU activation and the ungated MLP that applies it,
attention at head_dim 192 with a GQA group of 12, prefill and decode
logits of the reduced model in fp32 and bf16, both engines' greedy tokens,
the serve CLI, and ``chip_smoke.py``'s streamed fp32 reference (the logits
check of a model whose fp32 tables do not fit on the card) against the
model's own fp32 prefill and decode.

Inputs are numpy arrays from a seed; the JAX package's own initialised
weights are carried across by ``repro_torch.convert``. On CPU tensors the
port's kernels run their plain versions; the JAX side runs its chunked
attention, or the Pallas kernel in interpret mode where T divides its
block.

Tolerances:
- squared-ReLU alone: exact (one rounding of the same square either side);
- fp32 activations, hidden states and caches within 1e-5 of the tensor's
  largest magnitude (the same math in another summation order); the
  logits of an fp32 model, which ``lm_logits`` rounds to bf16 as JAX's
  does, within one bf16 ulp of each logit more;
- attention: fp32 2e-5 and bf16 2e-2 as |got - want| <= tol + tol * |want|,
  the kernels' tolerances in ``tests/test_torch_kernels.py``;
- bf16 logits of the reduced model within twice the JAX package's own bf16
  error (its bf16 run against its fp32 run on the same weights), plus one
  bf16 ulp of the largest logit for the final rounding of either side;
- the streamed reference as the fp32 logits above: both sides round
  the same fp32 logits to bf16 after sums taken in another order.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.kernels import build, flash_attention
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine

flash_module = importlib.import_module("repro_torch.kernels.flash_attention")

ARCH = "nemotron_4_340b"
HIDDEN_TOL = 1e-5
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WIDE = dict(n_heads=12, n_kv_heads=1, head_dim=192)   # nemotron's hd, group 12

jax_decode_step = jax.jit(JM.decode_step, static_argnums=1)


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               param_dtype=dtype, remat="none", **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


_SETUPS = {}


def _setup(dtype="float32", wide=False):
    """(jcfg, tcfg, jparams, tparams), built once per (dtype, wide)."""
    key = dtype, wide
    if key not in _SETUPS:
        jcfg, tcfg = _cfgs(dtype, **(WIDE if wide else {}))
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu")
        _SETUPS[key] = jcfg, tcfg, jparams, tparams
    return _SETUPS[key]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close_scaled(got, want, tol):
    scale = max(float(np.abs(_np(want)).max()), 1e-30)
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= tol * scale, (err, tol * scale)


def _bf16_ulps(x):
    """One bf16 ulp at each |x| (the logits are rounded to bf16)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def _within_an_ulp(got, want):
    """fp32 logits rounded to bf16 on both sides: within one bf16 ulp of
    each logit (a rounding that fell the other way) plus HIDDEN_TOL of the
    largest."""
    got, want = _np(got), _np(want)
    tol = _bf16_ulps(want) + HIDDEN_TOL * float(np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


# --------------------------------------------------------------------------
# config and activation
# --------------------------------------------------------------------------
def test_config_equals_jax_by_id_and_name():
    """The full config and ``reduced()`` equal the JAX package's field for
    field, by id and by dashed name."""
    jcfg = jax_get_config(ARCH)
    cfg = get_config(ARCH)
    assert cfg == ArchConfig(**dataclasses.asdict(jcfg))
    assert get_config("nemotron-4-340b") == cfg
    assert cfg.reduced() == ArchConfig(**dataclasses.asdict(jcfg.reduced()))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (18432, 96, 8, 192, 73728, 256000)
    assert not cfg.gated_mlp and not cfg.tie_embeddings
    assert cfg.activation == "squared_relu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_squared_relu_equals_jax(dtype):
    """``activation_fn("squared_relu")`` is JAX's ``square(relu(x))`` bit
    for bit, negatives to 0."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(JC.activation_fn("squared_relu")(jx).astype(jnp.float32))
    got = TC.activation_fn("squared_relu")(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(got[tx < 0].abs().max()) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ungated_squared_relu_mlp_vs_jax(dtype):
    """``mlp_forward`` with nemotron's ungated squared-ReLU MLP against
    ``repro/models/mlp.py::mlp_forward``: the activation in fp32, cast back
    to x's dtype, then the down projection. bf16: within 2x JAX's own bf16
    error against its fp32 run on the same bf16 weights."""
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    d, f = jcfg.d_model, jcfg.d_ff
    arrays = {"w_up": rng.standard_normal((d, f)) / np.sqrt(d),
              "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in arrays.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(tdt)
          for k, v in arrays.items()}
    want = JMLP.mlp_forward(jp, jcfg, jnp.asarray(x).astype(jdt))
    got = TMLP.mlp_forward(tp, tcfg, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and "w_gate" not in tp
    if dtype == "float32":
        _close_scaled(got, want, HIDDEN_TOL)
        return
    jp32 = {k: v.astype(jnp.float32) for k, v in jp.items()}
    x32 = jnp.asarray(x).astype(jdt).astype(jnp.float32)
    exact = _np(JMLP.mlp_forward(jp32, jcfg, x32))
    own = float(np.abs(_np(want) - exact).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= 2 * own


# --------------------------------------------------------------------------
# attention at hd 192, GQA 12
# --------------------------------------------------------------------------
def _qkv(seed, T, S, dtype, H=12, KV=1, hd=192):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, T, H, hd), (1, S, KV, hd), (1, S, KV, hd))]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _attn_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,q_offset", [(128, 128, 0), (128, 256, 128)])
def test_attention_hd192_group12_vs_pallas(dtype, T, S, q_offset):
    """H=12 KV=1 hd=192, causal, against the Pallas kernel in interpret
    mode (one 128-row query block)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, T, S, dtype)
    want = jax_flash(jq, jk, jv, causal=True, q_offset=q_offset,
                     block_q=128, block_k=128, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=q_offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,q_offset", [(1, 77, 76), (37, 100, 63),
                                          (9, 9, 0)])
def test_attention_hd192_group12_ragged_vs_jax(dtype, T, S, q_offset):
    """A decode-shaped call (T=1 at q_offset S-1), a ragged prefill against
    a longer cache, and a short square one: the port's ``attend`` against
    JAX's ``attend`` (chunked) at the same q_offset."""
    jcfg, tcfg = _cfgs(dtype, **WIDE)
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, T, S, dtype)
    want = JA.attend(jq, jk, jv, jcfg, causal=True, q_offset=q_offset)
    got = TA.attend(tq, tk, tv, tcfg, causal=True, q_offset=q_offset)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_takes_hd192_for_the_forward_only(dtype):
    """Both forwards take hd 192 (their C switches have the case); the
    backward does not, and raises NotImplementedError naming the ROADMAP
    item before any launch; its C switch has no hd 192 case."""
    q = torch.zeros(1, 8, 12, 192, dtype=dtype)
    kv = torch.zeros(1, 8, 1, 192, dtype=dtype)
    flash_module._check(q, kv, kv)
    with pytest.raises(NotImplementedError,
                       match="head_dim 192 .*ROADMAP.md queue 2 item 1"):
        flash_module._check(q, kv, kv, backward=True)
    text = {p.name: p.read_text() for p in build.sources()}
    assert "case 192:" in text["flash_attention_sm90.cu"]
    assert "case 192:" in text["flash_attention.cu"]
    assert "case 192:" not in text["flash_attention_bwd.cu"]
    assert "case 192:" not in text["flash_attention_bwd_sm90.cu"]
    assert "m64n192k16" in (build.CSRC / "sm90.cuh").read_text()


# --------------------------------------------------------------------------
# the reduced model
# --------------------------------------------------------------------------
def _prefill_decode(jcfg, tcfg, jparams, tparams, T=13, steps=4, seed=5):
    """(port logits, JAX logits, port cache, JAX cache): prefill of two
    prompts of T tokens, then ``steps`` decode steps at a scalar
    cache_len."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (2, T))
    follow = rng.integers(0, jcfg.vocab_size, (steps, 2))
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), pad=8)
    tl, tc = TM.prefill(tparams, tcfg, _t(tokens), pad=8)
    got, want = [tl], [jl]
    for i, tok in enumerate(follow):
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                 jc, jnp.int32(T + i))
        tl, tc = TM.decode_step(tparams, tcfg, _t(tok), tc, T + i)
        got.append(tl)
        want.append(jl)
    return (np.stack([_np(x) for x in got]), np.stack([_np(x) for x in want]),
            tc, jc)


@pytest.mark.parametrize("wide", [False, True])
def test_prefill_and_decode_logits_fp32(wide):
    """Reduced nemotron (4 layers, d 128, hd 32, untied head), and the same
    at nemotron's head shape (H=12 KV=1 hd 192: RoPE over 192 dims, GQA
    12): prefill and four decode steps, logits and every KV cache leaf."""
    jcfg, tcfg, jparams, tparams = _setup("float32", wide)
    assert "lm_head" in tparams and "w_gate" not in tparams["stages"][0]["mlp"]
    got, want, tc, jc = _prefill_decode(jcfg, tcfg, jparams, tparams)
    _within_an_ulp(got, want)
    for g, w in zip(tc["stages"][0]["kv"], jc["stages"][0]["kv"]):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g, w, HIDDEN_TOL)


def test_prefill_and_decode_logits_bf16():
    """Reduced nemotron in bf16 (JAX's own init, bf16 params): the port's
    logits within twice the JAX package's bf16 error against its fp32 run
    on the same weights, plus one bf16 ulp of the largest logit."""
    jcfg, tcfg, jparams, tparams = _setup("bfloat16")
    got, want, _, _ = _prefill_decode(jcfg, tcfg, jparams, tparams)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32")
    jparams32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                       jparams)
    exact, _, _, _ = _prefill_decode(jcfg32, ArchConfig(
        **dataclasses.asdict(jcfg32)), jparams32,
        convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams32),
                         device="cpu"))
    own = float(np.abs(want - exact).max())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert own > 0
    assert float(np.abs(got - want).max()) <= 2 * own + ulp


def test_engine_greedy_tokens_equal_jax():
    """Both engines (2 slots, prompts of 5, 13 and 30 tokens, reduced fp32)
    give the same greedy tokens."""
    jcfg, tcfg, jparams, tparams = _setup("float32")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 13, 30)]
    jeng = JaxServeEngine(jcfg, jparams, slots=2, max_seq=64)
    teng = ServeEngine(tcfg, tparams, slots=2, max_seq=64, device="cpu")
    jrids = [jeng.submit(p, max_new=6) for p in prompts]
    trids = [teng.submit(p, max_new=6) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    want = [jdone[r].tokens for r in jrids]
    assert [tdone[r].tokens for r in trids] == want
    assert all(len(t) == 6 for t in want)


def test_serve_cli_serves_nemotron(capsys):
    """``python -m repro_torch.launch.serve --arch nemotron-4-340b`` through
    the registry (its reduced config, fp32), on the CPU."""
    serve_cli.main(["--arch", "nemotron-4-340b", "--requests", "3",
                    "--slots", "2", "--max-seq", "32", "--max-new", "3",
                    "--device", "cpu"])
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


# --------------------------------------------------------------------------
# chip_smoke.py's streamed fp32 reference
# --------------------------------------------------------------------------
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("wide", [False, True])
def test_streamed_fp32_reference_equals_prefill_and_decode(wide):
    """``streamed_logits``: bf16 weights upcast one layer at a time, the
    head one vocabulary chunk at a time, prompt and forced tokens as one
    causal sequence, against the model's own prefill and decode steps on
    an fp32 copy of the same weights (bf16 -> fp32 is exact)."""
    smoke = _chip_smoke()
    _, tcfg, _, _ = _setup("bfloat16", wide)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, tcfg.vocab_size, 11)
    forced = rng.integers(0, tcfg.vocab_size, 4).tolist()
    params32 = TC.tree_map(lambda t: t.float(), params)
    toks = torch.as_tensor(prompt[None])
    logits, cache = TM.prefill(params32, tcfg, toks, pad=len(forced) + 1)
    want = [logits[0]]
    for i, tok in enumerate(forced):
        logits, cache = TM.decode_step(params32, tcfg, torch.tensor([tok]),
                                       cache, torch.tensor([len(prompt) + i]))
        want.append(logits[0])
    want = torch.stack(want).float()
    got, kernels = smoke.streamed_logits(params, tcfg, prompt, forced,
                                         vocab_chunk=100)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(kernels, got)       # CPU tensors: plain versions both
    _within_an_ulp(got, want)

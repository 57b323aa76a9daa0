"""The port's step builder and one-card dry-run (``repro_torch.launch.steps``,
``repro_torch.launch.dryrun``) against the JAX package.

Abstract, for all 10 archs x 4 shapes (no tensor has storage; ~10 s for
both sides):
- the skip rule equals ``repro.configs.base.shape_applicable``;
- ``input_specs``' shapes and dtypes equal ``repro.launch.steps.
  input_specs``', ids excepted: the port's ids are ``torch.long`` where
  JAX's are int32 (``train.step.shaped_batch``), so the arguments' bytes
  differ from JAX's by exactly 4 bytes an id, and by nothing else;
- the meta params equal ``repro.models.abstract_params`` key path by key
  path (``repro_torch.convert``'s paths), the AdamW state
  ``jax.eval_shape(adamw_init)``'s, the decode cache
  ``jax.eval_shape(init_cache)``'s;
- ``param_count`` and ``active_param_count`` equal JAX's.

At reduced widths (2 layers: qwen3-0.6b's ATTN blocks, xlstm-1.3b's mLSTM
and sLSTM; d_model 128, fp32), one set of weights in JAX's tree (drawn by
the port's ``init_params`` from a seeded generator, JAX's distributions)
given to both sides through ``convert``:
- ``build_step``'s prefill and decode programs, run on the CPU, against
  JAX's ``prefill`` and ``decode_step`` (logits within ``LOGIT_TOL``,
  every cache leaf within ``HIDDEN_TOL`` of its largest magnitude: the
  tolerances of ``tests/test_torch_xlstm.py``);
- its train program against JAX's gradients of the same batch taken
  through the clip and AdamW's first step in float64 (the tolerances of
  ``tests/test_torch_recurrent_train.py``, whose helpers it uses: see
  ``test_train_program_vs_composed_jax``);
- each kernel's meta path gives its CPU plain version's shapes and dtypes,
  forward and backward, records its work and launches nothing, and raises
  where the card raises;
- the dry-run's flops for a reduced dense prefill against
  ``repro.launch.hloparse.cost_summary`` of the same JAX program compiled
  on the CPU. Two terms differ by design: the port counts the flash
  kernel's visible (causal) pairs, 4·B·H·hd·T(T+1)/2 a layer, where JAX's
  chunked attention runs dots over all T² pairs; and it counts RMSNorm's
  4·rows·d, which ``cost_summary`` (dots and convolutions only) leaves
  out. The rest, the aten matrix products, equals JAX's dots within 1e-9.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import shape_applicable as jax_shape_applicable
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jax_steps
from repro.launch.hloparse import cost_summary
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.kernels import LAUNCHES, work
from repro_torch.kernels.flash_attention import flash_attention, visible
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (build_step, host_scalar, input_specs,
                                      real_args)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from test_torch_recurrent_train import B1, STEP, _adam64, _moved, _paths
from test_torch_xlstm import HIDDEN_TOL, LOGIT_TOL

ID_BYTES = 8 - 4          # torch.long against JAX's int32
NUDGE = 2.0 ** -22        # two fp32 ulps: the floor's params


def _walk(tree, path=""):
    """{key path: leaf} over dicts, lists and tuples (JAX's keystr form)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk(v, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_walk(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def _sig(tree):
    """{key path: (shape, dtype name)} of a tree of tensors or
    ShapeDtypeStructs."""
    out = {}
    for path, x in _walk(tree).items():
        name = (str(x.dtype).removeprefix("torch.")
                if isinstance(x, torch.Tensor) else np.dtype(x.dtype).name)
        out[path] = (tuple(x.shape), name)
    return out


def _jax_bytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in _walk(tree).values())


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JM.abstract_params(jax_get_config(arch))


def _jax_args(arch, shape_name):
    """JAX's abstract arguments of the cell's program, as
    ``repro.launch.steps`` builds them (without a mesh)."""
    cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    params = _jax_params(arch)
    specs = jax_steps.input_specs(cfg, shape)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda: jax_adamw.adamw_init(
            params, cfg.opt_state_dtype))
        return (params, opt, specs, i32)
    if shape.kind == "prefill":
        return (params, {k: v for k, v in specs.items() if k != "labels"})
    return (params, specs["token"], specs["cache"], specs["cache_len"])


def _id_elements(tree) -> int:
    return sum(math.prod(x.shape) for x in _walk(tree).values()
               if isinstance(x, torch.Tensor) and x.dtype == torch.long)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_match_jax_abstractly(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.is_subquadratic == jcfg.is_subquadratic
    for name, shape in SHAPES.items():
        ok = shape_applicable(cfg, shape)
        assert ok == jax_shape_applicable(jcfg, JAX_SHAPES[name])
        if not ok[0]:
            with pytest.raises(ValueError, match="500k"):
                build_step(cfg, shape, device="meta")
            continue
        # the cell's inputs: ids long where JAX's are int32, else equal
        got, want = _sig(input_specs(cfg, shape)), _sig(
            jax_steps.input_specs(jcfg, JAX_SHAPES[name]))
        assert got.keys() == want.keys()
        for path, (shp, dt) in got.items():
            wshp, wdt = want[path]
            assert shp == wshp, (name, path)
            assert dt == wdt or (dt, wdt) == ("int64", "int32"), (name, path)
        # every argument: params, moments, batch, cache by key path
        spec = build_step(cfg, shape, device="meta")
        jargs = _jax_args(arch, name)
        assert len(spec.args) == len(jargs)
        for mine, theirs in zip(spec.args, jargs):
            g, w = _sig(mine), _sig(theirs)
            assert g.keys() == w.keys(), (name, set(g) ^ set(w))
            for path in g:
                if g[path][1] == "int64":
                    assert w[path] == (g[path][0], "int32"), (name, path)
                else:
                    assert g[path] == w[path], (name, path)
        # the bytes differ by the ids' width alone
        got_bytes = dryrun.storage_bytes(spec.args)
        assert got_bytes - _jax_bytes(jargs) == ID_BYTES * _id_elements(
            spec.args)


def _small(arch):
    """The arch's reduced config cut to 2 layers (xlstm: an mLSTM and an
    sLSTM block), fp32 params and moments, no remat."""
    cfg = jax_get_config(arch).reduced()
    extra = {"xlstm_slstm_every": 2} if cfg.xlstm_slstm_every else {}
    return dataclasses.replace(cfg, n_layers=2, block_pattern=(),
                               param_dtype="float32",
                               opt_state_dtype="float32", remat="none",
                               **extra)


@functools.lru_cache(maxsize=None)
def _small_params(arch):
    """Weights for both sides as a numpy tree in JAX's layout: the port's
    ``init_params`` (the JAX package's distributions) from a seeded
    generator, carried across by ``convert`` (no JAX compile)."""
    tcfg = ArchConfig(**dataclasses.asdict(_small(arch)))
    params = convert.to_numpy(init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    want = _sig(JM.abstract_params(_small(arch)))
    assert _sig(params) == want, "the trees differ"
    return params


def _port(arch):
    """(the port's config, JAX's params carried across)."""
    return (ArchConfig(**dataclasses.asdict(_small(arch))),
            convert.to_torch(_small_params(arch), device="cpu"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-1.3b"])
def test_prefill_and_decode_programs_vs_jax(arch):
    jcfg, jparams = _small(arch), _small_params(arch)
    tcfg, tparams = _port(arch)
    B, T, pad = 2, 16, 64
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (B, T))

    pre = build_step(tcfg, ShapeConfig("p", T, B, "prefill"), device="cpu")
    assert pre.name == "prefill_step"
    assert _sig(pre.args[1]) == {"['tokens']": ((B, T), "int64")}
    tl, tc = pre.fn(tparams, {"tokens": torch.from_numpy(tokens)})
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                        pad=pad)
    _close(tl, jl, LOGIT_TOL)
    _close_trees(tc, jc)

    # a decode cell of T + pad positions takes JAX's cache after the
    # prompt, carried across
    dec = build_step(tcfg, ShapeConfig("d", T + pad, B, "decode"),
                     device="cpu")
    assert dec.name == "serve_step" and dec.donate == (2,)
    tc = convert.to_torch(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert _sig(tc) == _sig(dec.args[2])
    token = rng.integers(0, tcfg.vocab_size, (B,))
    tl, tc = dec.fn(tparams, torch.from_numpy(token), tc, host_scalar(T))
    jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(token, jnp.int32), jc,
                            jnp.int32(T))
    _close(tl, jl, LOGIT_TOL)
    _close_trees(tc, jc)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_trees(got, want):
    """Every leaf within HIDDEN_TOL of its largest magnitude."""
    g = _walk(convert.to_numpy(got))
    w = _walk(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys()
    for path, x in w.items():
        x = np.asarray(x, np.float64)
        err = np.abs(np.asarray(g[path], np.float64) - x).max()
        assert err <= HIDDEN_TOL * max(np.abs(x).max(), 1e-30), (path, err)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    """JAX's jitted ``value_and_grad`` of ``forward_loss``."""
    cfg = _small(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, cfg, b)[0]))


@functools.lru_cache(maxsize=None)
def _jax_grads_of(arch, reorder=False):
    """(loss, {path: gradient}) of JAX's ``forward_loss`` on
    ``_train_batch()``. With ``reorder``, the floor of two fp32 programs:
    the batch's rows reversed (the same sums in another order) and every
    param scaled by 1 + NUDGE, so that fp32 logits a few ulps apart (as
    the port's and JAX's are) round to bf16 apart where they sit at a
    rounding midpoint, as theirs do."""
    batch, params = _train_batch(), _small_params(arch)
    if reorder:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
        params = jax.tree_util.tree_map(lambda p: p * np.float32(1 + NUDGE),
                                        params)
    loss, grads = _jax_value_and_grad(arch)(params, batch)
    return float(loss), _paths(grads)


def _train_batch():
    return JaxSyntheticLM(256, 16, 2, seed=0).batch(STEP)


def _first_update(loss, grads, p0, lr):
    """The reference step in float64 from JAX's gradients: the clip by the
    global norm, then AdamW's first step from zero moments
    (``_adam64``)."""
    gn = float(np.sqrt(sum((g * g).sum() for g in grads.values())))
    scale = min(1.0, 1.0 / gn)
    out = {"loss": loss, "grad_norm": gn, "g": {}, "p": {}, "m": {},
           "v": {}, "terms": {}}
    for path, g in grads.items():
        (p, m, v), terms = _adam64(g * scale, p0[path], lr)
        out["g"][path] = g * scale
        out["p"][path], out["m"][path], out["v"][path] = p, m, v
        out["terms"][path] = terms
    return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-1.3b"])
def test_train_program_vs_composed_jax(arch):
    """The spec's step at step 1 (the default schedule's lr, 3e-6) from
    fresh moments against JAX's gradients of the same batch taken through
    the clip and AdamW's first step in float64. The floor is JAX against
    itself on the batch's rows reversed with its params two ulps off
    (``_jax_grads_of``): the loss and the grad norm within twice it plus 1e-6 of
    their size, the moments within twice it plus 2e-5 of the leaf's
    largest magnitude, the params within 1e-6 of their terms plus what the
    two sides' gradients move the float64 update by (Adam's first step is
    ~lr sign(g))."""
    tcfg, params = _port(arch)
    batch = _train_batch()
    B, T = batch["tokens"].shape
    spec = build_step(tcfg, ShapeConfig("t", T, B, "train"), device="cpu")
    assert spec.name == "train_step" and spec.donate == (0, 1)
    assert _sig(params) == _sig(spec.args[0])
    opt = adamw_init(params, "float32")
    assert _sig(opt) == _sig(spec.args[1])
    params, opt, met = spec.fn(params, opt, batch, host_scalar(STEP))
    lr = float(met["lr"])
    assert lr == pytest.approx(3e-4 * STEP / 100, rel=1e-6)

    p0 = _paths(_small_params(arch))
    want = _first_update(*_jax_grads_of(arch), p0, lr)
    alt = _first_update(*_jax_grads_of(arch, reorder=True), p0, lr)
    for key, got in (("loss", float(met["loss"])),
                     ("grad_norm", float(met["grad_norm"]))):
        floor = abs(alt[key] - want[key])
        assert abs(got - want[key]) <= 2 * floor + 1e-6 * abs(want[key])
    got = {"m": _paths(convert.to_numpy(opt["m"])),
           "v": _paths(convert.to_numpy(opt["v"])),
           "p": _paths(convert.to_numpy(params))}
    for kind in ("m", "v"):
        assert got[kind].keys() == want[kind].keys()
        for path, w in want[kind].items():
            floor = np.abs(alt[kind][path] - w).max()
            err = np.abs(got[kind][path] - w).max()
            assert err <= 2 * floor + 2e-5 * np.abs(w).max(), (kind, path)
    moved = _moved({"grads": {p: m / (1 - B1) for p, m in got["m"].items()},
                    "grad_norm": 1.0},
                   {"grads": want["g"], "grad_norm": 1.0}, p0, lr)
    for path, w in want["p"].items():
        dist = moved[path][0][0]
        err = np.abs(got["p"][path] - w)
        assert (err <= 1e-6 * want["terms"][path][0] + dist).all(), path


# --------------------------------------------------------------------------
# the kernels' meta paths
# --------------------------------------------------------------------------
def _flash(dev, dtype, hd, **mask):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, hd, generator=g).to(dtype)
    k = torch.randn(2, 24, 2, hd, generator=g).to(dtype)
    v = torch.randn(2, 24, 2, hd, generator=g).to(dtype)
    q, k, v = (t.to(dev).requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, **mask)
    return out, torch.autograd.grad(out.float().sum(), (q, k, v))


def _norm(dev, dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 10, 96, generator=g).to(dtype).to(dev)
    gain = torch.randn(96, generator=g).to(dtype).to(dev)
    x.requires_grad_(True), gain.requires_grad_(True)
    out = rmsnorm(x, gain)
    return out, torch.autograd.grad(out.float().sum(), (x, gain))


def _ssd(dev, N, P, norm):
    g = torch.Generator().manual_seed(2)
    b, T, H, G = 2, 70, 4, 2
    x = torch.randn(b, T, H, P, generator=g)
    a = -torch.rand(b, T, H, generator=g)
    B = torch.randn(b, T, G, N, generator=g) * 0.1
    C = torch.randn(b, T, G, N, generator=g) * 0.1
    w = torch.rand(b, T, H, generator=g) if norm else None
    ins = [t.to(dev).requires_grad_(True) for t in (x, a, B, C)]
    kw = {} if w is None else {"norm_weights": w.to(dev).requires_grad_(True)}
    out = ssd_scan(*ins, **kw)
    leaves = ins + list(kw.values())
    return out, torch.autograd.grad(out[0].sum() + out[-1].sum(), leaves)


def _slstm(dev, r_dtype):
    g = torch.Generator().manual_seed(3)
    B, T, nh, dh = 2, 9, 2, 32
    wx = (torch.randn(B, T, nh, 4 * dh, generator=g) * 0.5).to(dev)
    r = (torch.randn(nh, dh, 4 * dh, generator=g) * 0.1).to(r_dtype).to(dev)
    b = torch.zeros(nh, 4 * dh).to(dev)
    leaves = [t.requires_grad_(True) for t in (wx, r, b)]
    hs, state = slstm_scan(*leaves)
    return (hs, state), torch.autograd.grad(hs.sum() + state[0].sum(), leaves)


META_CASES = {
    "flash fp32 causal": (lambda d: _flash(d, torch.float32, 32),
                          ("flash_attention", "flash_attention_bwd")),
    "flash bf16 window": (lambda d: _flash(d, torch.bfloat16, 64, window=8),
                          ("flash_attention", "flash_attention_bwd")),
    "flash bf16 non-causal hd 80": (
        lambda d: _flash(d, torch.bfloat16, 80, causal=False),
        ("flash_attention", "flash_attention_bwd")),
    "rmsnorm fp32": (lambda d: _norm(d, torch.float32),
                     ("rmsnorm", "rmsnorm_bwd")),
    "rmsnorm bf16": (lambda d: _norm(d, torch.bfloat16),
                     ("rmsnorm", "rmsnorm_bwd")),
    "ssd chunks": (lambda d: _ssd(d, 16, 32, False),
                   ("ssd_scan", "ssd_scan_bwd")),
    "ssd walk + normalizer": (lambda d: _ssd(d, 128, 96, True),
                              ("ssd_scan", "ssd_scan_bwd")),
    "slstm r fp32": (lambda d: _slstm(d, torch.float32),
                     ("slstm_scan", "slstm_scan_bwd")),
    "slstm r bf16": (lambda d: _slstm(d, torch.bfloat16),
                     ("slstm_scan", "slstm_scan_bwd")),
}


@pytest.mark.parametrize("case", list(META_CASES))
def test_kernel_meta_path_gives_the_plain_shapes(case):
    run, names = META_CASES[case]
    want = run("cpu")
    launches = dict(LAUNCHES)
    work.FLOPS.clear()
    got = run("meta")
    assert dict(LAUNCHES) == launches             # nothing launched
    assert set(work.FLOPS) == set(names) and min(work.FLOPS.values()) > 0
    g, w = _walk(got), _walk(want)
    assert g.keys() == w.keys()
    for path, t in g.items():
        assert t.device.type == "meta", path
        assert (t.shape, t.dtype) == (w[path].shape, w[path].dtype), path


def test_meta_path_work_is_the_bound_formula():
    work.FLOPS.clear()
    _flash("meta", torch.bfloat16, 64, window=8)
    fwd = work.flash_fwd(2, 24, 24, 4, 2, 64, 2, True, 8)
    bwd = work.flash_bwd(2, 24, 24, 4, 2, 64, 2, True, 8, residual=True)
    assert work.FLOPS["flash_attention"] == fwd.flops
    assert work.FLOPS["flash_attention_bwd"] == bwd.flops
    # visible pairs: a row sees min(t + 1, 8) keys
    assert fwd.flops == 4 * 2 * 4 * 64 * sum(min(t + 1, 8) for t in range(24))


@pytest.mark.parametrize("T,S,causal,window,q_offset", [
    (137, 137, True, 0, 0), (137, 137, True, 40, 0), (37, 100, True, 0, 63),
    (1, 100, True, 0, 76), (100, 1500, False, 0, 0), (1000, 1000, True, 128,
                                                       0)])
def test_work_counts_the_visible_mask(T, S, causal, window, q_offset):
    """``work.visible_pairs`` and ``visible_tiles`` (the bounds' and the
    tile rates' counts) against the kernels' mask, ``visible``."""
    ok = visible(T, S, q_offset, causal, window, "cpu")
    assert work.visible_pairs(T, S, causal, window, q_offset) == int(ok.sum())
    if q_offset == 0:
        tiles = torch.nn.functional.pad(ok, (0, -S % 64, 0, -T % 64))
        tiles = tiles.reshape(-(-T // 64), 64, -(-S // 64), 64).any(3).any(1)
        assert work.visible_tiles(T, S, causal, window) == int(tiles.sum())


def test_meta_paths_raise_where_the_card_does():
    for dtype in (torch.float32, torch.bfloat16):     # no hd 192 backward
        with pytest.raises(NotImplementedError, match="head_dim 192"):
            _flash("meta", dtype, 192)
    with pytest.raises(NotImplementedError, match="head_dim 80"):
        _flash("meta", torch.float32, 80)
    wx = torch.empty(17, 4, 2, 128, device="meta")    # B past MAX_BATCH
    with pytest.raises(ValueError, match="B <= 16"):
        slstm_scan(wx, torch.empty(2, 32, 128, device="meta"),
                   torch.empty(2, 128, device="meta"))
    with pytest.raises(ValueError, match="state size"):
        x = torch.empty(1, 8, 2, 16, device="meta")
        ssd_scan(x, torch.empty(1, 8, 2, device="meta"),
                 *(torch.empty(1, 8, 1, 12, device="meta"),) * 2)


# --------------------------------------------------------------------------
# the dry-run's tallies and CLI
# --------------------------------------------------------------------------
def test_live_bytes_counts_storages_from_birth_to_death():
    arg = torch.empty(100, device="meta")
    with dryrun.LiveBytes(exclude=(arg,)) as mem:
        a = torch.empty(1000, device="meta")          # 4000 B
        b = torch.empty(2000, device="meta")          # 8000 B
        view = a[10:]                                 # no new storage
        same = arg.mul_(2)                            # an argument's
        del a, view
        c = torch.empty(500, device="meta")           # 2000 B
    assert (mem.peak, mem.live) == (12000, 10000)
    assert same is arg and b.numel() + c.numel() == 2500


def test_dryrun_flops_vs_hloparse_of_the_jax_prefill():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               param_dtype="float32")
    B, T = 2, 64
    hlo = jax.jit(lambda p, t: JM.prefill(p, jcfg, t)).lower(
        JM.abstract_params(jcfg),
        jax.ShapeDtypeStruct((B, T), jnp.int32)).compile().as_text()
    jax_flops = cost_summary(hlo).flops
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    got = dryrun.evaluate(build_step(tcfg, ShapeConfig("p", T, B, "prefill"),
                                     device="meta"))
    L, H, hd, d = tcfg.n_layers, tcfg.n_heads, tcfg.head_dim, tcfg.d_model
    KV = tcfg.n_kv_heads
    visible = 4 * B * H * hd * (T * (T + 1) // 2) * L
    everything = 4 * B * H * hd * T * T * L          # JAX's chunked dots
    assert got["kernel_flops"]["flash_attention"] == visible
    aten = got["flops"] - sum(got["kernel_flops"].values())
    assert abs(aten - (jax_flops - everything)) <= 1e-9 * jax_flops
    # RMSNorm: 4 flops an element of ln1, q_norm, k_norm and ln2 in every
    # layer, and of the final norm at the last position
    normed = L * B * T * (2 * d + (H + KV) * hd) + B * d
    assert got["kernel_flops"]["rmsnorm"] == 4 * normed


def test_dryrun_cli_records_and_merges(tmp_path):
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                      "--out", out])
    assert rc == 0
    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                      "--out", out])
    assert rc == 0
    rc = dryrun.main(["--arch", "xlstm-1.3b", "--shape", "prefill_32k",
                      "--out", out])
    assert rc == 1                                    # a failed cell
    with open(tmp_path / dryrun.OUT_NAME) as f:
        recs = {(r["arch"], r["shape"]): r for r in json.load(f)}
    assert len(recs) == 3
    ok = recs["whisper-small", "decode_32k"]
    cfg = get_config("whisper-small")
    spec = build_step(cfg, SHAPES["decode_32k"], device="meta")
    assert ok["status"] == "ok" and ok["program"] == "serve_step"
    assert ok["chips"] == 1 and ok["params"] == cfg.param_count()
    assert ok["memory"]["argument_bytes"] == dryrun.storage_bytes(spec.args)
    assert ok["memory"]["output_bytes"] > 0 and ok["flops_per_device"] > 0
    assert recs["qwen3-0.6b", "long_500k"]["status"] == "skip"
    fail = recs["xlstm-1.3b", "prefill_32k"]
    assert fail["status"] == "fail" and "B <= 16" in fail["reason"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-vl-7b",
                                  "whisper-small"])
def test_real_args_match_the_abstract_ones(arch):
    cfg = get_config(arch).reduced()
    for shape in (ShapeConfig("t", 64, 4, "train"),
                  ShapeConfig("d", 64, 2, "decode")):
        spec = build_step(cfg, shape, device="cpu")
        args = real_args(spec, cfg, "cpu", seed=0)
        assert _sig(args) == _sig(spec.args)
        assert dryrun.storage_bytes(args) == dryrun.storage_bytes(spec.args)
        again = real_args(spec, cfg, "cpu", seed=0)
        assert all(torch.equal(x, y) for x, y in zip(
            _walk(args).values(), _walk(again).values()))
        if shape.kind == "train":
            batch = args[2]
            assert 0 <= int(batch["tokens"].min()) <= int(
                batch["tokens"].max()) < cfg.vocab_size
            if "pos3" in batch:            # positions, on all three axes
                assert torch.equal(batch["pos3"][0, 0], torch.arange(64))
                assert int(batch["patch_pos"].max()) < 64
            # the program runs on them (the plain versions on the CPU)
            _, _, met = spec.fn(*args)
            assert torch.isfinite(met["loss"])

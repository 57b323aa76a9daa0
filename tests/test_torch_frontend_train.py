"""Training the two frontend archs on the CPU, the port against the JAX
package: reduced ``whisper-small`` (2 encoder and 4 decoder layers, the
cross attention over ``frames``) and reduced ``qwen2-vl-7b`` (4 layers,
M-RoPE ids, patch embeddings set into the token stream), both d_model 128,
hd 32, in bf16 and fp32, with 1 and 2 microbatches; and ``shaped_batch``
for every arch.

The batch is ``SyntheticLM`` 4 x 32 at step 1 plus the modality inputs at
``shaped_batch``'s train shapes, filled from a seeded ``torch.Generator``:
whisper's ``frames`` [4, 32, 128] (the train shape's encoder length is T),
qwen2-vl's ``patch_embeds`` [4, 8, 128], N(0, 0.02^2) rounded to bf16 (so
the fp32 and bf16 runs see the same values), at positions 2-9 as a 2 x 4
grid with Qwen2-VL's M-RoPE ids (``mrope_ids``). Weights are JAX's own
init carried across by ``repro_torch.convert``, the QKV biases drawn
nonzero into both trees (``tests/test_torch_vlm.py``'s).

As ``tests/test_torch_recurrent_train.py`` does (``make_train_step``
raises under the installed jax), the JAX step is composed from its parts:
``forward_loss`` and ``jax.value_and_grad`` per microbatch of the JAX
package's own ``_microbatch_stack`` (so at k = 2 ``pos3`` is split on its
axis 1), the fp32 mean, ``cosine_warmup`` and ``adamw_update``.

Tolerances, as that file states them:
- fp32: each gradient leaf, the loss and the grad norm within twice JAX's
  own sum-order floor (JAX against itself with the rows of each
  microbatch reversed: the same sums in another order, nothing else) plus
  2e-5 of the leaf's largest magnitude (1e-6 relative for the loss and
  norm); each updated param and moment within 1e-6 of its terms plus what
  the two sides' gradients move a float64 AdamW update by.
- bf16: the loss within twice the mean over tokens of JAX's bf16 per-token
  loss deviation from its fp32 model; each gradient leaf (``forward_loss``
  alone) within twice JAX's bf16 gradient's largest distance from its fp32
  one; in the step, the grad norm within twice the norm of JAX's bf16
  gradient error and every updated param and moment within twice JAX's
  bf16 step's largest distance from its fp32 step plus what the gradients
  move a float64 update by.
- A key bias's gradient (``bk``) is 0 in exact arithmetic: the bias adds
  q . bk to every score of a query's row, which the softmax cancels. What
  either side computes for it is rounding alone, so it is held to the
  tolerance of the same attention's ``bq`` gradient (its floor and its
  largest magnitude), a sum of terms of the same size (the rows of dq
  where bk's are the rows of dk).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro.train.step import _microbatch_stack as jax_microbatch_stack
from repro.train.step import shaped_batch as jax_shaped_batch
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ArchConfig, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import forward_loss
from repro_torch.models.common import tree_leaves
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.step import (_microbatch_stack, loss_and_grads,
                                    shaped_batch, to_batch)
from test_torch_recurrent_train import (PEAK_LR, STEP, TOTAL, WARMUP, _cast,
                                        _config, _moved, _paths, _port_step)
from test_torch_vlm import with_random_biases

ARCHS = ("whisper-small", "qwen2-vl-7b")
B, T = 4, 32
PATCH_AT = 2
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mrope_ids(n: int, T: int, at: int, rows: int, cols: int):
    """[3, n, T] int32 M-RoPE ids with one ``rows`` x ``cols`` image at
    ``at``, as Qwen2-VL's rope index lays it out: text before it at
    t = h = w = i, patch (r, c) at (at, at + r, at + c), text after it from
    at + max(rows, cols) on."""
    ids = np.empty((3, T), np.int64)
    ids[:, :at] = np.arange(at)
    r, c = np.divmod(np.arange(rows * cols), cols)
    end = at + rows * cols
    ids[:, at:end] = np.stack([np.full_like(r, at), at + r, at + c])
    ids[:, end:] = at + max(rows, cols) + np.arange(T - end)
    return np.broadcast_to(ids[:, None], (3, n, T)).astype(np.int32).copy()


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """numpy tokens / labels and the modality inputs at ``shaped_batch``'s
    train shapes (embeddings as float32 holding bf16 values)."""
    cfg = get_config(arch).reduced()
    out = dict(JaxSyntheticLM(cfg.vocab_size, T, B, seed=0).batch(STEP))
    meta = shaped_batch(cfg, ShapeConfig("cpu_train", T, B, "train"))
    gen = torch.Generator().manual_seed(7)
    for name in ("frames", "patch_embeds"):
        if name in meta:
            x = 0.02 * torch.randn(meta[name].shape, generator=gen)
            out[name] = x.to(torch.bfloat16).float().numpy()
    if "pos3" in meta:
        npatch = meta["patch_pos"].shape[1]
        rows = 2
        out["pos3"] = mrope_ids(B, T, PATCH_AT, rows, npatch // rows)
        out["patch_pos"] = np.broadcast_to(
            np.arange(PATCH_AT, PATCH_AT + npatch), (B, npatch)
        ).astype(np.int32).copy()
    return out


def _jax_batch(arch, dtype):
    return {k: jnp.asarray(v, JAX_DTYPES[dtype]) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in _inputs(arch).items()}


def _torch_batch(arch, dtype):
    return {k: torch.from_numpy(v).to(TORCH_DTYPES[dtype])
            if v.dtype == np.float32 else v for k, v in _inputs(arch).items()}


def _reordered(batch, k):
    """``batch`` with the rows of each of its ``k`` microbatches reversed:
    the same sums in another order."""
    n = B // k
    perm = np.concatenate([np.arange((i + 1) * n - 1, i * n - 1, -1)
                           for i in range(k)])
    return {name: (x[:, perm] if name == "pos3" else x[perm])
            for name, x in batch.items()}


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The reduced arch's params in bf16, QKV biases nonzero."""
    cfg = _config(arch, "bfloat16", 1)
    params = jax.jit(lambda key: JM.init_params(cfg, key))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        np.asarray, with_random_biases(params, np.random.default_rng(9)))


def _params(arch, dtype):
    return _cast(_init(arch), JAX_DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _grad_fn(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, cfg, b)[0]))


def _jax_grads(cfg, params, batch, k):
    """The reference step's microbatch loop on ``_microbatch_stack``'s
    microbatches: fp32 sums, then / k."""
    stacked = jax_microbatch_stack(batch, k)
    acc, loss_acc = None, 0.0
    for i in range(k):
        loss, g = _grad_fn(cfg)(params, {n: x[i] for n, x in stacked.items()})
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
        loss_acc = loss_acc + loss
    return loss_acc / k, jax.tree_util.tree_map(lambda g: g / k, acc)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, dtype, k, moments=None, reverse=False):
    """The composed reference step from the arch's params in ``dtype`` and
    fresh moments; with ``reverse`` on ``_reordered``'s batch."""
    cfg = _config(arch, dtype, k, moments)
    params = _params(arch, dtype)
    batch = _jax_batch(arch, dtype)
    if reverse:
        batch = _reordered(batch, k)
    loss, grads = _jax_grads(cfg, params, batch, k)
    opt = jax_adamw.adamw_init(params, cfg.opt_state_dtype)
    lr = jax_cosine_warmup(jnp.int32(STEP), peak_lr=PEAK_LR,
                           warmup_steps=WARMUP, total_steps=TOTAL)
    new_p, new_o, gn = jax_adamw.adamw_update(grads, opt, params, lr=lr)
    return {"loss": float(loss), "grad_norm": float(gn), "lr": float(lr),
            "grads": _paths(grads), "p": _paths(new_p),
            "m": _paths(new_o["m"]), "v": _paths(new_o["v"])}


@functools.lru_cache(maxsize=None)
def _jax_token_nll(arch, dtype):
    """Per-token next-token losses of ``forward_loss`` with the modality
    inputs (every label valid)."""
    cfg = _config(arch, dtype, 1)

    @jax.jit
    def nll(params, batch):
        enc_out = (JM.encode(params, cfg, batch["frames"]) if cfg.enc_dec
                   else None)
        h, _ = JM.forward_hidden(params, cfg, batch["tokens"],
                                 pos3=batch.get("pos3"), enc_out=enc_out,
                                 patch_embeds=batch.get("patch_embeds"),
                                 patch_pos=batch.get("patch_pos"))
        logits = JM.lm_logits(params, cfg, h)[:, :-1].astype(jnp.float32)
        tgt = jnp.take_along_axis(logits, batch["tokens"][:, 1:, None],
                                  axis=-1)
        return jax.nn.logsumexp(logits, axis=-1) - tgt[..., 0]
    return np.asarray(nll(_params(arch, dtype), _jax_batch(arch, dtype)))


def _held_as(path: str) -> str:
    """The leaf whose floor and magnitude a gradient leaf is held to: its
    own, or for ``bk`` the same attention's ``bq``."""
    return path[:-len("['bk']")] + "['bq']" if path.endswith("['bk']") \
        else path


def _nll_floor(arch):
    return float(np.mean(np.abs(_jax_token_nll(arch, "bfloat16")
                                - _jax_token_nll(arch, "float32"))))


# --------------------------------------------------------------------------
# shaped_batch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_shaped_batch_matches_jax(arch, shape):
    """The same leaves with JAX's shapes, as tensors on the meta device (no
    storage); bf16 where JAX's are bf16, and int64 ids where JAX's are
    int32 (the dtype ``to_batch`` gives ids)."""
    want = jax_shaped_batch(jax_get_config(arch), JAX_SHAPES[shape])
    got = shaped_batch(get_config(arch), SHAPES[shape])
    assert got.keys() == want.keys()
    for name, w in want.items():
        t = got[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(w.shape), name
        assert t.dtype == {jnp.dtype(jnp.int32): torch.long,
                           jnp.dtype(jnp.bfloat16): torch.bfloat16}[w.dtype]
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_stack_matches_jax(arch, k):
    """The port's microbatches of a modality batch are JAX's, leaf for leaf
    (pos3 cut on its axis 1), and ``to_batch`` keeps the embeddings'
    dtype."""
    want = jax_microbatch_stack(_jax_batch(arch, "bfloat16"), k)
    got = _microbatch_stack(to_batch(_torch_batch(arch, "bfloat16"), "cpu"),
                            k)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.dtype == (torch.bfloat16 if g.is_floating_point()
                           else torch.long), name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32), name)


# --------------------------------------------------------------------------
# forward_loss's gradients
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch, dtype, reverse=False):
    cfg = _config(arch, dtype, 1)
    batch = _jax_batch(arch, dtype)
    if reverse:
        batch = _reordered(batch, 1)
    loss, grads = _grad_fn(cfg)(_params(arch, dtype), batch)
    return float(loss), _paths(grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_vs_jax(arch, dtype):
    """``forward_loss``'s loss and every gradient leaf with the modality
    inputs against ``jax.value_and_grad`` of JAX's."""
    tcfg = ArchConfig(**dataclasses.asdict(_config(arch, dtype, 1)))
    tp = convert.to_torch(_params(arch, dtype), "cpu")
    loss, grads = loss_and_grads(tp, tcfg, to_batch(_torch_batch(arch, dtype),
                                                    "cpu"))
    got = _paths(convert.to_numpy(grads))
    want_loss, want = _jax_loss_grads(arch, dtype)
    assert got.keys() == want.keys()
    if dtype == "float32":
        alt_loss, alt = _jax_loss_grads(arch, dtype, reverse=True)
        floor = abs(alt_loss - want_loss)
        assert abs(float(loss) - want_loss) <= 2 * floor + 1e-6 * abs(
            want_loss)
        for path, w in want.items():
            q = _held_as(path)
            floor = np.abs(alt[q] - want[q]).max()
            err = np.abs(got[path] - w).max()
            assert err <= 2 * floor + 2e-5 * np.abs(want[q]).max(), (
                path, err, floor)
        return
    loss32, want32 = _jax_loss_grads(arch, "float32")
    assert abs(float(loss) - loss32) <= 2 * _nll_floor(arch)
    for path, w32 in want32.items():
        q = _held_as(path)
        floor = np.abs(want[q] - want32[q]).max()
        err = np.abs(got[path] - w32).max()
        assert err <= 2 * floor, (path, err, floor)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_frontend_step_vs_composed_jax(arch, k):
    want = _jax_step(arch, "float32", k, "float32")
    alt = _jax_step(arch, "float32", k, "float32", reverse=True)
    cfg = _config(arch, "float32", k, "float32")
    got = _port_step(cfg, _params(arch, "float32"),
                     _torch_batch(arch, "float32"), k)
    for key in ("loss", "grad_norm"):
        floor = abs(alt[key] - want[key])
        assert abs(got[key] - want[key]) <= 2 * floor + 1e-6 * abs(want[key])
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert got["grads"].keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        q = _held_as(path)
        floor = np.abs(alt["grads"][q] - want["grads"][q]).max()
        err = np.abs(got["grads"][path] - w).max()
        assert err <= 2 * floor + 2e-5 * np.abs(want["grads"][q]).max(), (
            path, err, floor)
    p0 = _paths(_params(arch, "float32"))
    moved = _moved(got, want, p0, want["lr"])
    for i, kind in enumerate("pmv"):
        for path, w in want[kind].items():
            dist, terms = moved[path]
            err = np.abs(got[kind][path] - w)
            assert (err <= 1e-6 * terms[i] + dist[i]).all(), (kind, path)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_frontend_step_vs_composed_jax(arch, k):
    cfg = _config(arch, "bfloat16", k)
    want16 = _jax_step(arch, "bfloat16", k)
    want32 = _jax_step(arch, "float32", k)
    got = _port_step(cfg, _params(arch, "bfloat16"),
                     _torch_batch(arch, "bfloat16"), k)
    assert abs(got["loss"] - want32["loss"]) <= 2 * _nll_floor(arch)
    gn_floor = np.sqrt(sum(np.sum((want16["grads"][q] - want32["grads"][q])
                                  ** 2) for q in want16["grads"]))
    assert abs(got["grad_norm"] - want32["grad_norm"]) <= 2 * gn_floor
    assert got["lr"] == pytest.approx(want16["lr"], rel=1e-6)
    moved = _moved(got, want16, _paths(_params(arch, "bfloat16")),
                   want16["lr"])
    for i, kind in enumerate("pmv"):
        assert got[kind].keys() == want16[kind].keys()
        for path, exact in want32[kind].items():
            err = np.abs(got[kind][path] - exact)
            floor = np.abs(want16[kind][path] - exact).max()
            assert (err <= 2 * floor + moved[path][0][i]).all(), \
                (kind, path, err.max(), floor)


# --------------------------------------------------------------------------
# the Trainer with a modality batch_fn
# --------------------------------------------------------------------------
def whisper_batch_fn(cfg, B_: int, T_: int):
    """``SyntheticLM`` B_ x T_ and frames [B_, T_, d] ~ N(0, 0.02^2) in the
    params' dtype, drawn per step from a generator seeded by the step."""
    src = SyntheticLM(cfg.vocab_size, T_, B_, seed=0)

    def batch(step):
        gen = torch.Generator().manual_seed(step)
        frames = 0.02 * torch.randn(B_, T_, cfg.d_model, generator=gen)
        return {**src.batch(step), "frames": frames.to(TORCH_DTYPES[
            cfg.param_dtype])}
    return batch


def test_trainer_whisper_resumes_with_frames(tmp_path):
    """Reduced whisper (one encoder and one decoder layer, fp32, remat none,
    2 microbatches: the test is the Trainer's, the numerics are held above)
    through the Trainer with frames from its batch_fn: 4 straight steps,
    then 2 steps with a checkpoint at step 2 and a new Trainer that resumes
    there and repeats steps 3-4's losses, params and moments bit for bit;
    the frames move the loss."""
    cfg = dataclasses.replace(get_config("whisper-small").reduced(),
                              n_layers=1, n_enc_layers=1, microbatches=2,
                              param_dtype="float32", remat="none")
    batch_fn = whisper_batch_fn(cfg, B, T // 2)

    def trainer(name, every):
        tc = TrainerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=every,
                           peak_lr=PEAK_LR, warmup=WARMUP, total_steps=TOTAL,
                           log_every=10_000)
        return Trainer(cfg, batch_fn, tc, device="cpu", log=lambda s: None)

    straight = trainer("a", 10_000)
    losses = straight.run(4)["losses"]
    assert all(np.isfinite(losses))
    first = trainer("b", 2)
    assert first.run(2)["losses"] == losses[:2]
    first.mgr.wait()
    resumed = trainer("b", 2)
    assert resumed.step == 2
    assert resumed.run(2)["losses"] == losses[2:]
    for a, b in zip(tree_leaves({"p": straight.params,
                                 "o": straight.opt_state}),
                    tree_leaves({"p": resumed.params,
                                 "o": resumed.opt_state})):
        assert torch.equal(a, b)
    batch = to_batch(batch_fn(0), "cpu")
    assert batch["frames"].dtype == torch.float32
    moved = forward_loss(straight.params, cfg,
                         {**batch, "frames": batch["frames"].flip(0)})[0]
    assert float(moved) != float(forward_loss(straight.params, cfg,
                                              batch)[0])

"""The port's fault-tolerant trainer (``repro_torch.train.trainer``), its
data pipeline and its training CLI on the CPU: the counterparts of
``tests/test_trainer.py``'s five tests (which fail on the JAX side under
the installed jax), a Trainer resuming from a checkpoint the JAX package
wrote against the JAX package's step composed from its parts, the copied
``PackedBinReader`` and ``make_batch_fn`` against the JAX package's bit for
bit, and ``python -m repro_torch.launch.train`` in a subprocess.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.data import pipeline as jax_pipeline
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup
from repro_torch import convert
from repro_torch.ckpt import latest_step
from repro_torch.configs import ArchConfig
from repro_torch.configs.base import SHAPES
from repro_torch.data import PackedBinReader, SyntheticLM, make_batch_fn
from repro_torch.models.common import tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parents[1] / "src"


def jax_tiny_cfg():
    """``tests/test_trainer.py``'s ``tiny_cfg``."""
    return dataclasses.replace(
        jax_get_config("qwen3_0_6b").reduced(),
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, block_pattern=(), remat="none",
        param_dtype="float32")


def tiny_cfg():
    return ArchConfig(**dataclasses.asdict(jax_tiny_cfg()))


def batch_fn_for(cfg, B=4, T=16):
    src = SyntheticLM(cfg.vocab_size, T, B, seed=0)
    return lambda step: src.batch(step)


def trainer(cfg, tc):
    return Trainer(cfg, batch_fn_for(cfg), tc, device="cpu",
                   log=lambda s: None)


def test_trainer_loss_decreases(tmp_path):
    cfg = tiny_cfg()
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                       peak_lr=1e-2, warmup=5, total_steps=100,
                       log_every=1000)
    out = trainer(cfg, tc).run(30)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)


def test_trainer_restart_exactness(tmp_path):
    """20 straight steps == 10 steps + restart-from-ckpt + 10 steps, bit for
    bit on the CPU: losses, params and moments."""
    cfg = tiny_cfg()
    tc_a = TrainerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=10_000,
                         peak_lr=1e-2, log_every=10_000)
    tr_a = trainer(cfg, tc_a)
    out_a = tr_a.run(20)

    tc_b = TrainerConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=10,
                         peak_lr=1e-2, log_every=10_000)
    tr_b1 = trainer(cfg, tc_b)
    tr_b1.run(10)
    tr_b1.mgr.wait()
    tr_b2 = trainer(cfg, tc_b)
    assert tr_b2.step == 10                        # resumed
    out_b2 = tr_b2.run(10)
    assert out_b2["losses"] == out_a["losses"][10:]
    for a, b in zip(tree_leaves({"p": tr_a.params, "o": tr_a.opt_state}),
                    tree_leaves({"p": tr_b2.params, "o": tr_b2.opt_state})):
        assert torch.equal(a, b)


def test_trainer_preemption_checkpoints(tmp_path):
    cfg = tiny_cfg()
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10_000,
                       log_every=10_000)
    tr = trainer(cfg, tc)
    orig = tr.step_fn
    calls = {"n": 0}

    def step_with_signal(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)   # preemption notice
        return orig(*a, **k)

    tr.step_fn = step_with_signal
    out = tr.run(50)
    assert out["preempted"]
    assert out["step"] == 3                        # stopped promptly
    assert latest_step(str(tmp_path)) == 3         # checkpointed on signal
    assert signal.getsignal(signal.SIGTERM) is not tr._on_preempt


def test_trainer_retries_transient_failures(tmp_path):
    cfg = tiny_cfg()
    tc = TrainerConfig(ckpt_dir=str(tmp_path), max_retries=3,
                       log_every=10_000)
    tr = trainer(cfg, tc)
    orig = tr.step_fn
    fails = {"left": 2}
    devices = []

    def flaky(params, *a, **k):
        devices.append(tree_leaves(params)[0].device)
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("transient device error")
        return orig(params, *a, **k)

    tr.step_fn = flaky
    out = tr.run(3)
    assert out["step"] == 3                        # survived 2 failures
    assert devices == [torch.device("cpu")] * 5    # retried where it was


def test_trainer_exhausted_retries_checkpoint_and_raise(tmp_path):
    cfg = tiny_cfg()
    tc = TrainerConfig(ckpt_dir=str(tmp_path), max_retries=1,
                       log_every=10_000)
    tr = trainer(cfg, tc)

    def dead(*a, **k):
        raise RuntimeError("hard failure")

    tr.step_fn = dead
    with pytest.raises(RuntimeError, match="hard failure"):
        tr.run(5)
    assert latest_step(str(tmp_path)) is not None  # emergency checkpoint


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(tiny_cfg(), batch_fn_for(tiny_cfg()),
                TrainerConfig(ckpt_dir=str(tmp_path)), log=lambda s: None)


def test_trainer_resumes_a_jax_checkpoint_as_jax_continues(tmp_path):
    """The JAX package writes its params and AdamW state after 2 steps; the
    port's Trainer resumes there and its losses for steps 2..5 are the
    JAX package's step composed from its parts (fp32, within 1e-5 along
    chained steps, as tests/test_torch_train.py)."""
    jcfg = jax_tiny_cfg()
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10_000,
                       peak_lr=1e-2, warmup=3, total_steps=20,
                       log_every=10_000)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, jcfg, b)[0]))

    @jax.jit
    def update(g, o, p, step):
        lr = jax_cosine_warmup(step, peak_lr=tc.peak_lr,
                               warmup_steps=tc.warmup,
                               total_steps=tc.total_steps)
        return jax_adamw.adamw_update(g, o, p, lr=lr)

    src = jax_pipeline.SyntheticLM(jcfg.vocab_size, 16, 4, seed=0)
    params = JM.init_params(jcfg, jax.random.PRNGKey(5))
    opt = jax_adamw.adamw_init(params, "float32")
    losses = []
    for s in range(6):
        if s == 2:
            jax_ckpt.save(str(tmp_path), 2, {"params": params, "opt": opt},
                          meta={"arch": jcfg.name})
        batch = {k: jnp.asarray(v) for k, v in src.batch(s).items()}
        loss, g = grad(params, batch)
        params, opt, _ = update(g, opt, params, jnp.int32(s))
        losses.append(float(loss))
    tr = trainer(tiny_cfg(), tc)
    assert tr.step == 2
    out = tr.run(4)
    assert out["step"] == 6
    np.testing.assert_allclose(out["losses"], losses[2:], rtol=1e-5)


# --------------------------------------------------------------------------
# data: the copies give the JAX package's batches bit for bit
# --------------------------------------------------------------------------
def _same(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed,step,hosts,host", [(0, 0, 1, 0), (5, 3, 1, 0),
                                                  (2, 1, 2, 0), (2, 1, 2, 1)])
def test_packed_corpus_batches_bit_for_bit(tmp_path, seed, step, hosts,
                                           host):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 1000, size=10_000)
    PackedBinReader.write_corpus(str(tmp_path / "port.bin"), toks)
    jax_pipeline.PackedBinReader.write_corpus(str(tmp_path / "jax.bin"), toks)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "jax.bin").read_bytes())
    got = PackedBinReader(str(tmp_path / "port.bin"), 32, 8, seed=seed,
                          num_hosts=hosts, host_id=host).batch(step)
    want = jax_pipeline.PackedBinReader(str(tmp_path / "jax.bin"), 32, 8,
                                        seed=seed, num_hosts=hosts,
                                        host_id=host).batch(step)
    _same(got, want)


def test_corpus_too_small_raises(tmp_path):
    path = str(tmp_path / "tiny.bin")
    PackedBinReader.write_corpus(path, np.arange(10))
    with pytest.raises(ValueError, match="corpus too small"):
        PackedBinReader(path, seq_len=32, global_batch=1)


@pytest.mark.parametrize("corpus", [False, True])
def test_make_batch_fn_bit_for_bit(tmp_path, corpus):
    """Both sources through ``make_batch_fn`` (a path that does not exist
    falls back to the synthetic stream, as in the reference)."""
    cfg = tiny_cfg()
    path = str(tmp_path / "c.bin")
    if corpus:
        PackedBinReader.write_corpus(path, np.arange(5000) % 64)
    shape, jshape = SHAPES["train_4k"], JAX_SHAPES["train_4k"]
    small = dataclasses.replace(shape, seq_len=64, global_batch=4)
    jsmall = dataclasses.replace(jshape, seq_len=64, global_batch=4)
    fn = make_batch_fn(cfg, small, seed=3, corpus=path)
    jfn = jax_pipeline.make_batch_fn(jax_tiny_cfg(), jsmall, seed=3,
                                     corpus=path)
    for step in (0, 1, 7):
        _same(fn(step), jfn(step))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def _cli(*args, timeout=120):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_launch_train_cli_on_the_cpu(tmp_path):
    """The reduced qwen3 (bf16, remat full) for 3 steps on a packed corpus,
    with a checkpoint at step 2."""
    corpus = str(tmp_path / "corpus.bin")
    PackedBinReader.write_corpus(corpus, np.arange(20_000) % 256)
    proc = _cli("--device", "cpu", "--arch", "qwen3-0.6b", "--steps", "3",
                "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2",
                "--data", corpus)
    assert proc.returncode == 0, proc.stderr
    assert "arch=qwen3-0.6b-smoke device=cpu seq=64 batch=8" in proc.stdout
    assert "done at step 3" in proc.stdout
    assert latest_step(str(tmp_path / "ckpt")) == 2


def test_launch_train_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    proc = _cli("--arch", "qwen3-0.6b", "--steps", "1", "--ckpt-dir",
                str(tmp_path))
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr

"""The port's serving engine on the CPU.

Continuous batching must give the same greedy tokens as a plain
single-request loop over the port's own model functions (as
tests/test_serve.py holds the JAX engine to), and the port's engine-path
logits must match the JAX package's. Logits are bf16, so each greedy
reference asserts a top-2 margin above ``MARGIN`` at every step: a near tie
could otherwise flip with summation order between batch sizes.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serve.engine import ServeEngine

MARGIN = 1e-2
SEED = 14               # weights whose greedy runs below keep that margin
LOGIT_TOL = 1e-2        # bf16 logits: about one bf16 ulp at |logit| < 2
SRC = Path(__file__).resolve().parents[1] / "src"


def tiny_cfg(**kw):
    """The port's copy of tests/test_serve.py's ``tiny_cfg``."""
    cfg = dataclasses.replace(
        get_config("qwen3_0_6b").reduced(),
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, block_pattern=(), remat="none",
        param_dtype="float32")
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _params(cfg, seed):
    return init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _margin(logits):
    top2 = torch.topk(logits.float(), 2).values
    return float(top2[0] - top2[1])


def reference_generate(cfg, params, prompt, max_new):
    """Single-request greedy loop straight on the model functions (scalar
    cache_len), checking the top-2 margin at every step."""
    toks = torch.as_tensor(prompt)[None]
    logits, cache = prefill(params, cfg, toks, pad=max_new + 4)
    out = []
    pos = toks.shape[1]
    while True:
        assert _margin(logits[0]) > MARGIN, (out, _margin(logits[0]))
        out.append(int(torch.argmax(logits[0])))
        if len(out) == max_new:
            return out
        logits, cache = decode_step(params, cfg, torch.tensor([out[-1]]),
                                    cache, pos)
        pos += 1


def _engine(cfg, params, slots):
    return ServeEngine(cfg, params, slots=slots, max_seq=64, device="cpu")


def test_engine_matches_reference_single():
    cfg = tiny_cfg()
    params = _params(cfg, SEED)
    prompt = [3, 14, 15, 9, 2]
    want = reference_generate(cfg, params, prompt, 8)
    eng = _engine(cfg, params, slots=2)
    rid = eng.submit(np.asarray(prompt), max_new=8)
    assert eng.run()[rid].tokens == want


def test_engine_multi_request_continuous_batching():
    cfg = tiny_cfg()
    params = _params(cfg, SEED)
    prompts = [[1, 2, 3], [10, 20, 30, 40, 5, 6], [7], [9, 9, 9, 9]]
    wants = [reference_generate(cfg, params, p, 6) for p in prompts]
    eng = _engine(cfg, params, slots=2)                  # 4 reqs, 2 slots
    rids = [eng.submit(np.asarray(p), max_new=6) for p in prompts]
    done = eng.run()
    assert len(done) == 4
    for rid, want in zip(rids, wants):
        assert done[rid].tokens == want
    assert eng.stats["prefills"] == 4
    assert eng.stats["decode_steps"] >= 10               # slots were reused


def test_engine_eos_stops_early():
    cfg = tiny_cfg()
    params = _params(cfg, SEED)
    prompt = [3, 14, 15]
    free_run = reference_generate(cfg, params, prompt, 8)
    eos = free_run[2]
    eng = _engine(cfg, params, slots=1)
    rid = eng.submit(np.asarray(prompt), max_new=8, eos=eos)
    cut = free_run.index(eos) + 1
    assert eng.run()[rid].tokens == free_run[:cut]


def test_engine_sampling_follows_its_seed():
    cfg = tiny_cfg()
    params = _params(cfg, 2)
    runs = []
    for seed in (7, 7, 8):
        eng = ServeEngine(cfg, params, slots=2, max_seq=64, greedy=False,
                          seed=seed, device="cpu")
        rid = eng.submit(np.asarray([4, 5, 6]), max_new=12)
        runs.append(eng.run()[rid].tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 12
    assert runs[0] != runs[2]


def test_engine_path_logits_match_jax():
    """Teacher-forced: prefill at the exact length, then decode steps with
    a per-row cache_len vector, as both engines run them."""
    jcfg = dataclasses.replace(jax_get_config("qwen3_0_6b").reduced(),
                               n_layers=2, d_model=64, n_heads=2,
                               n_kv_heads=2, head_dim=32, d_ff=128,
                               vocab_size=64, block_pattern=(), remat="none",
                               param_dtype="float32")
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    prompt = np.array([[3, 14, 15, 9, 2]])
    forced = [11, 42, 7, 0, 63]
    max_seq = 32
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                        pad=max_seq - 5)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(prompt), pad=max_seq - 5)
    for i, tok in enumerate([None] + forced):
        if tok is not None:
            n = 5 + i - 1
            jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray([tok], jnp.int32),
                                    jc, jnp.asarray([n], jnp.int32))
            tl, tc = decode_step(tparams, tcfg, torch.tensor([tok]), tc,
                                 torch.tensor([n]))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServeEngine(cfg, _params(cfg, 0))


def test_submit_rejects_prompts_that_do_not_fit():
    cfg = tiny_cfg()
    eng = _engine(cfg, _params(cfg, 0), slots=1)
    for bad in ([], np.zeros(65, np.int64), [[1, 2]]):
        with pytest.raises(ValueError):
            eng.submit(bad)


def test_port_imports_neither_jax_nor_repro():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(SRC / "repro_torch")
                                  .with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py"))
    # a __main__ module runs its command when imported (the analyzer's
    # calls sys.exit), so the check leaves them out
    modules = [m.removesuffix(".__init__") for m in modules
               if not m.endswith(".__main__")]
    # the port's examples, imported from their files (main() not run)
    examples = sorted(str(p) for p in
                      (SRC.parent / "examples").glob("torch_*.py"))
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for i, p in enumerate({examples!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m.split('.')[0] in ('msgpack', 'ml_dtypes'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 15 and len(examples) == 5
    # the trainer's slice: nor msgpack or ml_dtypes, which the card's
    # machine does not have
    assert {"repro_torch.train.step", "repro_torch.train.trainer",
            "repro_torch.ckpt.checkpoint", "repro_torch.ckpt.msgpack",
            "repro_torch.optim.compress", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun"} <= set(modules)
    # the launch layer: the discrete-event reproduction, the sim and
    # real-process backends, the event protocol and the analyzer
    assert {"repro_torch.core.events", "repro_torch.core.cluster",
            "repro_torch.core.apps", "repro_torch.core.launcher",
            "repro_torch.core.scheduler", "repro_torch.core.realproc",
            "repro_torch.exec.sim", "repro_torch.exec.protocol",
            "repro_torch.exec.pool", "repro_torch.exec.procpool",
            "repro_torch.taskarray.runner_sim",
            "repro_torch.taskarray.runner_real",
            "repro_torch.taskarray.runner_inline",
            "repro_torch.analysis", "repro_torch.analysis.runner",
            "repro_torch.analysis.api", "repro_torch.analysis.events",
            "repro_torch.analysis.locks",
            "repro_torch.analysis.common"} <= set(modules)

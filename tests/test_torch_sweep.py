"""The port's sweep command line on the CPU: prepositioning, the sweep
supervisor, the copied task-array and exec layers, and
``repro_torch.launch.sweep.run_sweep`` against the JAX sweep.

- The prepositioning and supervisor tests mirror ``tests/test_preposition.py``
  on the port with ``devices=[cpu]``, asserting on counters, not the clock.
- The copies of ``repro.taskarray`` and ``repro.exec`` are held to the
  reference twice: their syntax trees (docstrings dropped, ``repro.`` read as
  ``repro_torch.`` in imports) and one graph run through both inline
  backends (values, per-task statuses and attempts, summary counts, event
  counts). ``get_backend`` resolves ``sim``, ``procpool`` and its alias
  ``real`` (the launch layer's own tests are ``test_torch_launch.py``,
  ``test_torch_procpool.py`` and ``test_torch_analysis.py``).
- The CLI: 2 members x 3 steps of ``run_sweep`` from converted JAX params
  against the JAX sweep's jitted ``member_step`` driven as its
  ``run_member`` drives it; final losses within ``LOSS_RTOL`` relative
  (fp32, the same math in another summation order; at lr 1e-4 the runs
  agree within 1e-6). Adam's first update is lr * sign(g), so at the
  grid's top lr, 3e-2, the few gradient elements near 0 whose sign fp32
  rounding decides move by 2 lr, and the third loss carries that. Against
  a float64 run of the same steps (``scripts/sweep_f64_arbiter.py``: JAX
  with x64, its models' F32 set to float64, the params drawn in fp32),
  JAX's fp32 run ends 1.8e-5 from it, JAX's op by op 2.0e-5 and the
  port's 3.0e-5 (relative). The port is no farther for a fault of its
  own: the float64 run fed the port's step-0 gradient ends 3.0e-5 from
  float64 too, so its whole distance is its step-0 gradient, which is as
  close to float64's as JAX's (max 9.5e-6 of a leaf's largest, against
  1.1e-5 and 7.9e-6) and has the other sign at 2 of 624,000 elements, as
  each JAX run has, all where float64's gradient is under 3e-7 of its
  leaf's largest. Which of those elements flip is rounding's choice, so
  the top lr's bound is ``SIGN_NOISE_RTOL``, twice JAX's own farthest
  fp32 run from float64. Not 5 steps: the sign noise compounds after the
  third update and the fifth losses differ by ~3e-3.
"""
from __future__ import annotations

import ast
import dataclasses
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jax_exec
import repro.taskarray as jax_taskarray
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import sweep as jax_sweep
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch import exec as port_exec
from repro_torch import taskarray as port_taskarray
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import (ChipQuota, CompileCacheWarmer,
                              SweepSupervisor, WeightPrepositioner,
                              cache_key, carve_devices)
from repro_torch.data import SyntheticLM
from repro_torch.launch import sweep
from repro_torch.models import forward_loss, init_params
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw_init

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
SIGN_NOISE_RTOL = 4.1e-5   # lr 3e-2: 2 x 2.04e-5, the module doc


def tiny_cfg():
    """The port's copy of tests/test_preposition.py's ``tiny_cfg``."""
    return dataclasses.replace(
        get_config("qwen3_0_6b").reduced(),
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=64, block_pattern=(), remat="none",
        param_dtype="float32")


class CountingBuild:
    """build() for the warmer: a miniature loss step on the CPU that counts
    its builds, its throwaway inputs and its runs."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = Counter()

    def __call__(self):
        self.calls["build"] += 1

        def step(params, batch):
            self.calls["step"] += 1
            return forward_loss(params, self.cfg, batch)[0]

        def make_args():
            self.calls["args"] += 1
            toks = torch.zeros(4, 16, dtype=torch.long)
            return (init_params(self.cfg, torch.Generator().manual_seed(0),
                                device="cpu"),
                    {"tokens": toks, "labels": toks})

        return step, make_args


# --------------------------------------------------------------------------
# prepositioning
# --------------------------------------------------------------------------
def test_warm_then_get_without_a_second_build():
    cfg, shape = tiny_cfg(), SHAPES["train_4k"]
    w, build = CompileCacheWarmer(), CountingBuild(tiny_cfg())
    entry = w.warm(cfg, shape, [CPU], build)
    assert entry.build_s == 0.0          # the CPU loads no kernel library
    assert entry.first_step_s >= 0
    assert build.calls == {"build": 1, "args": 1, "step": 1}
    assert w.stats == {"warms": 1, "hits": 0, "misses": 0}
    assert w.get(cfg, shape, [CPU]) is entry
    assert build.calls == {"build": 1, "args": 1, "step": 1}
    assert w.stats == {"warms": 1, "hits": 1, "misses": 0}


def test_warm_idempotent():
    cfg, shape = tiny_cfg(), SHAPES["train_4k"]
    w, build = CompileCacheWarmer(), CountingBuild(tiny_cfg())
    e1 = w.warm(cfg, shape, [CPU], build)
    e2 = w.warm(cfg, shape, (torch.device("cpu"),), build)
    assert e1 is e2
    assert w.stats["warms"] == 1 and build.calls["build"] == 1


def test_cold_get_raises():
    """First-call costs inside the interactive loop are the failure mode
    the paper engineered away: get() on a cold cache raises, and neither
    builds nor runs anything."""
    w = CompileCacheWarmer()
    with pytest.raises(KeyError):
        w.get(tiny_cfg(), SHAPES["train_4k"], [CPU])
    assert w.stats == {"warms": 0, "hits": 0, "misses": 1}


def test_cache_key_distinguishes_cells():
    cfg = tiny_cfg()
    keys = {
        cache_key(cfg, SHAPES["train_4k"], [CPU]),
        cache_key(cfg, SHAPES["prefill_32k"], [CPU]),
        cache_key(dataclasses.replace(cfg, name="other"),
                  SHAPES["train_4k"], [CPU]),
        cache_key(cfg, SHAPES["train_4k"], [torch.device("cuda", 0)]),
        cache_key(cfg, SHAPES["train_4k"], [torch.device("cuda", 1)]),
    }
    assert len(keys) == 5
    # by device identity, in the key's own order
    assert cache_key(cfg, SHAPES["train_4k"],
                     [torch.device("cuda", 1)])[2] == ("cuda:1",)


def test_weight_prepositioner():
    wp, cfg = WeightPrepositioner(), tiny_cfg()
    calls = {"n": 0}

    def init():
        calls["n"] += 1
        return {"w": torch.ones(4)}

    t1 = wp.preposition(cfg, [CPU], 0, init)
    t2 = wp.preposition(cfg, [CPU], 0, init)
    assert t1 is t2 and calls["n"] == 1
    assert wp.get(cfg, [CPU], 0) is t1
    with pytest.raises(KeyError):
        wp.get(cfg, [CPU], 1)
    with pytest.raises(KeyError):
        wp.get(cfg, [torch.device("cuda", 0)], 0)


# --------------------------------------------------------------------------
# sweep supervisor
# --------------------------------------------------------------------------
def test_chip_quota():
    q = ChipQuota(max_chips=8)
    assert q.try_acquire(8)
    assert not q.try_acquire(1)
    q.release(4)
    assert q.try_acquire(4)


def test_carve_devices():
    devs = [torch.device("cuda", i) for i in range(8)]
    groups = carve_devices(devs, 4)
    assert len(groups) == 4
    assert all(len(g) == 2 for g in groups)
    assert [d for g in groups for d in g] == devs
    with pytest.raises(AssertionError):
        carve_devices(devs, 3)


def test_supervisor_without_a_card_raises(monkeypatch):
    """With no devices the supervisor takes the CUDA cards; it never falls
    back to the CPU by itself, and neither does the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SweepSupervisor()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sweep.main(["--members", "1", "--steps", "1"])
    assert SweepSupervisor(devices=[CPU]).devices == (CPU,)


def _supervisor(max_chips):
    cfg, shape = tiny_cfg(), SHAPES["train_4k"]
    sup = SweepSupervisor(devices=[CPU], max_chips=max_chips)
    build = CountingBuild(cfg)
    sup.preposition(cfg, shape, [CPU], build)
    return sup, cfg, shape, build


def test_sweep_interactive_launch_without_builds():
    """The paper's workflow: preposition, then N launches with no build
    and no first-call step in the loop."""
    sup, cfg, shape, build = _supervisor(4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)))
    batch = {"tokens": toks, "labels": toks}

    def run_member(entry, member):
        return float(entry.step(params, batch))

    grid = [{"lr": lr} for lr in (1e-4, 3e-4, 1e-3, 3e-3)]
    members = sup.launch_sweep(cfg, shape, [CPU], grid, run_member)
    assert len(members) == 4
    assert all(m.state == "running" for m in members)
    assert all(m.launch_time is not None for m in members)
    assert sup.warmer.stats == {"warms": 1, "hits": 4, "misses": 0}
    assert build.calls == {"build": 1, "args": 1, "step": 5}
    assert len({m.result for m in members}) == 1
    rep = sup.launch_report()
    assert rep["n"] == 4 and rep["rate_per_s"] > 0


def test_sweep_quota_holds_over_limit():
    sup, cfg, shape, build = _supervisor(0)        # nothing allowed
    members = sup.launch_sweep(cfg, shape, [CPU], [{}], lambda e, m: None)
    assert members[0].state == "held"
    assert sup.warmer.stats["hits"] == 0


def test_sweep_quota_held_for_member_lifetime():
    """Chips are held from launch until release(), so members contend."""
    sup, cfg, shape, _ = _supervisor(2)            # 1 chip per member
    grid = [{"v": i} for i in range(4)]
    members = sup.launch_sweep(cfg, shape, [CPU], grid, lambda e, m: m.mid)
    assert [m.state for m in members] == ["running", "running",
                                         "held", "held"]
    assert sup.quota.held == 2                     # still held after launch
    sup.release(members[0])
    assert members[0].state == "finished"
    assert sup.quota.held == 1
    sup.release(members[0])                        # idempotent
    assert sup.quota.held == 1


def test_sweep_member_holds_all_its_devices():
    """A member's chips are the number of devices it is launched on."""
    cfg, shape = tiny_cfg(), SHAPES["train_4k"]
    sup = SweepSupervisor(devices=[CPU, CPU], max_chips=3)
    sup.preposition(cfg, shape, (CPU, CPU), CountingBuild(cfg))
    members = sup.launch_sweep(cfg, shape, (CPU, CPU), [{}, {}],
                               lambda e, m: m.mid)
    assert [m.state for m in members] == ["running", "held"]
    assert members[0].chips == 2 and sup.quota.held == 2


def test_sweep_retry_held_launches_backlog():
    sup, cfg, shape, _ = _supervisor(1)
    members = sup.launch_sweep(cfg, shape, [CPU],
                               [{"v": i} for i in range(3)],
                               lambda e, m: m.hparams["v"] * 10)
    assert [m.state for m in members] == ["running", "held", "held"]
    assert sup.retry_held() == []                  # no capacity yet
    sup.release(members[0])
    assert sup.retry_held() == [members[1]]        # one slot -> one member
    assert members[1].state == "running" and members[1].result == 10
    assert members[2].state == "held"
    sup.release(members[1])
    assert sup.retry_held() == [members[2]]
    sup.release(members[2])
    assert sup.quota.held == 0
    assert [m.result for m in members] == [0, 10, 20]
    assert sup.launch_report()["n"] == 3


def test_failed_launch_returns_its_chips():
    sup, cfg, shape, _ = _supervisor(1)

    def run_member(entry, member):
        raise ValueError("boom")

    [m] = sup.launch_sweep(cfg, shape, [CPU], [{}], run_member)
    assert m.state == "failed" and "boom" in m.result
    assert sup.quota.held == 0 and m.chips == 0


# --------------------------------------------------------------------------
# the copies of repro.taskarray and repro.exec
# --------------------------------------------------------------------------
COPIES = ["taskarray/dag", "taskarray/gather", "taskarray/api", "exec/base",
          "exec/chaos", "exec/driver", "exec/inline"]


def _tree(path, rename):
    """The module's syntax tree without docstrings; with ``rename``, the
    absolute ``repro.`` imports read as ``repro_torch.``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.startswith("repro."):
            node.module = "repro_torch." + node.module[len("repro."):]
        if rename and isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("repro."):
                    alias.name = "repro_torch." + alias.name[len("repro."):]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES)
def test_copy_is_the_reference_module(module):
    want = _tree(SRC / "repro" / f"{module}.py", rename=True)
    got = _tree(SRC / "repro_torch" / f"{module}.py", rename=False)
    assert got == want


def _graph(taskarray):
    """A map of 8 (task 3 fails its first attempt and is retried) and a
    reduce over it."""
    g = taskarray.TaskGraph("parity")
    squares = g.map(lambda p, _: p["i"] * p["i"],
                    [{"i": i} for i in range(8)], name="squares")
    squares.tasks[3].fail_attempts = 1
    g.reduce(lambda p, inputs: sum(inputs["squares"][p["lo"]:p["hi"]]),
             squares, name="total")
    return g


def _outcome(exec_pkg, taskarray):
    res = _graph(taskarray).run(exec_pkg.get_backend("inline", sleep=False),
                                taskarray.RetryPolicy(max_retries=2))
    out = {"events": res.events.counts(), "arrays": {}}
    for name, arr in res.items():
        s = arr.summary
        out["arrays"][name] = {
            "values": arr.values,
            "tasks": [(r.index, r.status, r.attempts, r.error)
                      for r in arr.results],
            "summary": (s.n_tasks, s.ok, s.failed, s.retries,
                        s.straggler_redispatches, s.lost)}
    return out


def test_inline_backend_runs_a_graph_as_the_reference_does():
    got = _outcome(port_exec, port_taskarray)
    want = _outcome(jax_exec, jax_taskarray)
    assert got == want
    squares = got["arrays"]["squares"]
    assert squares["values"] == [i * i for i in range(8)]
    assert squares["tasks"][3][2] == 2 and squares["summary"][3] == 1
    assert got["arrays"]["total"]["values"] == [140]


@pytest.mark.parametrize("name", ["sim", "procpool", "real"])
def test_unported_backends_raise(name):
    """``get_backend`` resolves the launch layer's backends, ``real`` as
    ``procpool``'s alias, and still raises for an unknown name. (The name
    is kept from when these three raised, before the launch layer was
    ported.)"""
    cls = "SimBackend" if name == "sim" else "ProcPoolBackend"
    with port_exec.get_backend(name) as b:    # spawns no process yet
        assert type(b) is getattr(port_exec, cls)
        assert isinstance(b, port_exec.ExecBackend)
    assert port_exec.ProcPoolBackend is \
        type(port_exec.get_backend("real")) is \
        type(port_exec.get_backend("procpool"))
    with pytest.raises(KeyError, match="unknown backend"):
        port_exec.get_backend("slurm")
    assert isinstance(port_exec.get_backend("inline", sleep=False),
                      port_exec.InlineBackend)


# --------------------------------------------------------------------------
# the command line against the JAX sweep
# --------------------------------------------------------------------------
def _jax_member_config():
    """``repro/launch/sweep.py:66-68``."""
    return dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                               n_layers=2, param_dtype="float32",
                               remat="none")


def _jax_sweep_losses(jparams, lrs, steps):
    """``repro.launch.sweep``'s ``run_member`` for each lr: from the same
    base params, fresh moments, ``SyntheticLM`` batches, the jitted
    ``member_step``; the last step's loss."""
    jcfg = _jax_member_config()
    step_fn = jax.jit(jax_sweep.build_member_step(jcfg,
                                                  make_host_mesh(1, 1))[0])
    src = JaxSyntheticLM(jcfg.vocab_size, 32, 8, seed=0)
    out = []
    for lr in lrs:
        params = jparams
        opt = jax_adamw.adamw_init(params, "float32")
        for step in range(steps):
            b = {k: jnp.asarray(v) for k, v in src.batch(step).items()}
            params, opt, loss = step_fn(params, opt, b, jnp.float32(lr))
        out.append(float(loss))
    return out


def test_run_sweep_matches_the_jax_sweep():
    members, steps = 2, 3
    jparams = JM.init_params(_jax_member_config(), jax.random.PRNGKey(0))
    base = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                            device="cpu")
    before = [t.clone() for t in tree_leaves(base)]
    run = sweep.run_sweep(sweep.member_config("qwen3-0.6b"), members, steps,
                          device="cpu", init=base)
    arr = run.result["sweep"]
    assert arr.summary.ok == members and arr.summary.failed == 0
    assert run.supervisor.warmer.stats == {"warms": 1, "hits": members,
                                           "misses": 0}
    assert run.supervisor.quota.held == 0
    assert run.supervisor.weights.get(sweep.member_config("qwen3-0.6b"),
                                      [CPU], 0) is base
    lrs = [m["lr"] for m in run.members]
    np.testing.assert_allclose(lrs, np.geomspace(1e-4, 3e-2, members))
    want = _jax_sweep_losses(jparams, lrs, steps)
    for m, w in zip(run.members, want):
        bound = SIGN_NOISE_RTOL if np.isclose(m["lr"], 3e-2) else LOSS_RTOL
        assert abs(m["loss"] - w) / w < bound, (m["lr"], m["loss"], w)
        assert m["launch_s"] is not None
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base), before))


def test_members_train_their_own_clones():
    """The optimizer updates in place: two members at one lr from one
    prepositioned tree give the same losses, and the tree is unchanged."""
    cfg = sweep.member_config("qwen3-0.6b")
    shape = SHAPES["train_4k"]
    sup = SweepSupervisor(devices=[CPU], max_chips=2)
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)

    def build():
        def make_args():
            p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
            return p, adamw_init(p), src.batch(0), 1e-3
        return sweep.build_member_step(cfg, device="cpu"), make_args

    sup.preposition(cfg, shape, [CPU], build, init=lambda: init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    base = sup.weights.get(cfg, [CPU], 0)
    before = [t.clone() for t in tree_leaves(base)]
    run_member = sweep.member_runner(base, 2, src)
    members = sup.launch_sweep(cfg, shape, [CPU], [{"lr": 1e-3}] * 2,
                               run_member)
    assert [m.state for m in members] == ["running", "running"]
    assert members[0].result == members[1].result
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base), before))


def test_main_on_the_cpu(capsys):
    sweep.main(["--device", "cpu", "--members", "2", "--steps", "1"])
    out = capsys.readouterr().out
    assert "prepositioned in" in out
    assert "launched 2/2 members x 1 steps" in out
    assert "0 held by quota; warms in loop: 0" in out
    for line in ("best member:", "array: [sweep] 2/2 ok", "events:",
                 "report: {'n': 2"):
        assert line in out

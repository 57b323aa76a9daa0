"""The port's five examples (``examples/torch_*.py``), run in process on the
CPU at small arguments. Each asserts what its JAX counterpart asserts,
here on counters and event traces, never on rates:

- quickstart: the loss falls over the Trainer's steps;
- serve_batch: every request is served, each with its ``max_new`` tokens,
  one prefill each;
- interactive_sweep: the warm cache is built once before the launch loop
  and never inside it (no warm, no miss), every member finishes, members
  launch in waves of the chip quota;
- fault_tolerance: the requeued job avoids the dead node; the chaos run
  ends with zero failed tasks, its lost attempts reported as LOST events;
  the resumed losses equal the uninterrupted run's bit for bit;
- mapreduce_wordstats: the top-k equals a plain count (the example raises
  where it does not), the injected failure retried.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from repro_torch.exec import LOST

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_loss_falls():
    out = _example("quickstart").main(["--steps", "12", "--device", "cpu"])
    assert len(out["losses"]) == 12 and out["step"] == 12
    assert out["losses"][-1] < out["losses"][0]


def test_serve_batch_serves_every_request():
    eng, done = _example("serve_batch").main(
        ["--requests", "5", "--slots", "2", "--device", "cpu"])
    assert len(done) == 5 and eng.stats["prefills"] == 5
    assert all(len(r.tokens) == r.max_new for r in done.values())
    assert eng.stats["decode_steps"] >= max(r.max_new for r in done.values())


def test_interactive_sweep_builds_nothing_in_the_loop():
    sup, members = _example("interactive_sweep").main(
        ["--members", "3", "--steps", "1", "--max-chips", "1",
         "--device", "cpu"])
    assert sup.warmer.stats == {"warms": 1, "hits": 3, "misses": 0}
    assert [m.state for m in members] == ["finished"] * 3
    assert sup.quota.held == 0 and sup.launch_report()["n"] == 3


def test_fault_tolerance_levels():
    ft = _example("fault_tolerance")
    job, events = ft.scheduler_level()
    assert job.requeues == 1 and [e[1] for e in events][:2] == [
        "dispatch", "requeue"]
    res, _ = ft.exec_level()        # respawns: when the pool notices
    arr = res["sq"]
    assert arr.summary.failed == 0 and arr.summary.ok == 8
    assert arr.summary.lost == res.events.counts().get(LOST, 0)
    out1, out2, ref = ft.trainer_level("cpu", steps=6, preempt_at=3)
    assert out1["step"] == 3 and out1["losses"] + out2["losses"] == ref


@pytest.mark.parametrize("backend", ["sim", "inline"])
def test_wordstats_top_k_equals_a_plain_count(backend):
    res = _example("mapreduce_wordstats").main(
        ["--backend", backend, "--inject", "--shards", "8"])
    assert res.all_ok and res["counts"].summary.retries >= 1
    assert res["top"].summary.n_tasks == 1

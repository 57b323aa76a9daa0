"""The port's checkpoints (``repro_torch.ckpt``) on the CPU: the
counterparts of ``tests/test_ckpt.py``'s tests that apply (no shardings:
one device), checkpoints crossing both ways between ``repro.ckpt`` and
``repro_torch.ckpt`` bit for bit (the reduced qwen3's params and AdamW
state in bf16 and fp32), and the port's MessagePack subset byte for byte
against the ``msgpack`` package, which only the tests use.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro_torch import convert
from repro_torch.ckpt import CheckpointManager, latest_step, restore, save
from repro_torch.ckpt import msgpack as port_msgpack
from repro_torch.models.common import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"


def tree(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 8))).to(dtype),
                   "stages": [torch.from_numpy(
                       rng.normal(size=(2, 3))).to(dtype)]},
        "count": torch.tensor(7, dtype=torch.int32),
    }


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    save(str(tmp_path), 5, t, meta={"arch": "x"})
    got, manifest = restore(str(tmp_path), t, device="cpu")
    assert manifest["step"] == 5
    assert manifest["meta"]["arch"] == "x"
    _equal(got, t)


def test_bf16_roundtrip(tmp_path):
    t = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(16,))).to(torch.bfloat16)}
    save(str(tmp_path), 1, t)
    got, manifest = restore(str(tmp_path), t, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert manifest["leaves"]["w"] == {"shape": [16], "dtype": "bfloat16"}
    _equal(got, t)


def test_latest_step_and_explicit_step(tmp_path):
    t = tree()
    for s in (3, 10, 7):
        save(str(tmp_path), s, t)
    assert latest_step(str(tmp_path)) == 10
    _, manifest = restore(str(tmp_path), t, step=7, device="cpu")
    assert manifest["step"] == 7
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "missing"), t, device="cpu")


def test_restore_casts_to_the_like_dtype(tmp_path):
    """A bf16 checkpoint restores into an fp32 ``like`` (and back) exactly:
    bf16 -> fp32 is exact."""
    t = tree(dtype=torch.bfloat16)
    save(str(tmp_path), 1, t)
    like = tree_map(lambda x: x.float() if x.is_floating_point() else x, t)
    got, _ = restore(str(tmp_path), like, device="cpu")
    assert got["params"]["w"].dtype == torch.float32
    assert torch.equal(got["params"]["w"].to(torch.bfloat16),
                       t["params"]["w"])


def test_missing_leaf_raises(tmp_path):
    t = tree()
    save(str(tmp_path), 1, t)
    bigger = dict(t)
    bigger["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing leaf extra"):
        restore(str(tmp_path), bigger, device="cpu")


def test_atomic_no_tmp_left(tmp_path):
    save(str(tmp_path), 1, tree())
    entries = os.listdir(tmp_path)
    assert entries == ["step_00000001"]
    assert sorted(os.listdir(tmp_path / entries[0])) == [
        "arrays.npz", "manifest.msgpack"]


def test_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    _, m = restore(str(tmp_path), t, device="cpu")
    assert m["step"] == 4


def test_manager_donation_safety(tmp_path):
    """save_async copies to the host before returning: updating the tree in
    place afterwards (as the train step does) must not reach the write."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    t = {"w": torch.ones(64), "b": torch.ones(64, dtype=torch.bfloat16)}
    mgr.save_async(9, t)
    t["w"].mul_(0)
    t["b"].mul_(0)
    mgr.wait()
    got, _ = restore(str(tmp_path), {"w": torch.zeros(64),
                                     "b": torch.zeros(64,
                                                      dtype=torch.bfloat16)},
                     device="cpu")
    assert torch.equal(got["w"], torch.ones(64))
    assert torch.equal(got["b"], torch.ones(64, dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# crossing between the two packages
# --------------------------------------------------------------------------
def _jax_train_state(dtype):
    """The reduced qwen3's params and AdamW state as the JAX package's
    trainer holds them, moments moved off zero so every bit is tested."""
    cfg = dataclasses.replace(jax_get_config("qwen3-0.6b").reduced(),
                              param_dtype=dtype)
    params = JM.init_params(cfg, jax.random.PRNGKey(3))
    opt = jax_adamw.adamw_init(params, "float32")
    rng = np.random.default_rng(4)
    opt = {"m": jax.tree_util.tree_map(
               lambda m: jnp.asarray(rng.normal(size=m.shape), m.dtype),
               opt["m"]),
           "v": jax.tree_util.tree_map(
               lambda v: jnp.asarray(rng.random(size=v.shape), v.dtype),
               opt["v"]),
           "count": jnp.int32(11)}
    return {"params": params, "opt": opt}


def _jax_paths(tree_):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree_)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    state = _jax_train_state(dtype)
    jax_ckpt.save(str(tmp_path), 12, state, meta={"arch": "qwen3-0.6b"})
    like = convert.to_torch(jax.tree_util.tree_map(np.asarray, state), "cpu")
    like = tree_map(torch.zeros_like, like)
    got, manifest = restore(str(tmp_path), like, device="cpu")
    assert manifest["step"] == 12 and manifest["meta"] == {
        "arch": "qwen3-0.6b"}
    _equal(got, convert.to_torch(jax.tree_util.tree_map(np.asarray, state),
                                 "cpu"))
    assert got["params"]["embed"].dtype == getattr(torch, dtype)
    assert got["opt"]["count"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    state = _jax_train_state(dtype)
    tstate = convert.to_torch(jax.tree_util.tree_map(np.asarray, state),
                              "cpu")
    save(str(tmp_path / "port"), 12, tstate, meta={"arch": "qwen3-0.6b"})
    got, manifest = jax_ckpt.restore(str(tmp_path / "port"), state)
    assert manifest["step"] == 12
    for (path, a), b in zip(_jax_paths(got).items(),
                            _jax_paths(state).values()):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    # the same files: npz keys and the manifest's leaves as JAX writes them
    jax_ckpt.save(str(tmp_path / "jax"), 12, state,
                  meta={"arch": "qwen3-0.6b"})
    files = {}
    for side in ("port", "jax"):
        d = tmp_path / side / "step_00000012"
        with np.load(d / "arrays.npz") as data:
            keys = list(data.files)
        with open(d / "manifest.msgpack", "rb") as f:
            files[side] = (keys, msgpack.unpackb(f.read()))
    assert files["port"][0] == files["jax"][0]
    port_manifest, jax_manifest = files["port"][1], files["jax"][1]
    assert port_manifest.pop("treedef") != jax_manifest.pop("treedef")
    assert port_manifest == jax_manifest
    assert list(port_manifest["leaves"]) == list(jax_manifest["leaves"])


# --------------------------------------------------------------------------
# the MessagePack subset
# --------------------------------------------------------------------------
VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.5, -1e300, "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "e" * 65536, "ünïcode ✓", b"", b"\x00\x01" * 200,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"nested": {"a": [1, {"b": None}], "c": [True, -5, "x"]}},
]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_msgpack_subset_bytes_equal_msgpack(value):
    data = port_msgpack.packb(value)
    assert data == msgpack.packb(value)
    assert port_msgpack.unpackb(data) == msgpack.unpackb(data)


def test_msgpack_manifest_bytes_equal_msgpack(tmp_path):
    """A trainer's manifest (the reduced qwen3's params and opt state)."""
    state = convert.to_torch(jax.tree_util.tree_map(
        np.asarray, _jax_train_state("bfloat16")), "cpu")
    save(str(tmp_path), 3, state, meta={"arch": "qwen3-0.6b-smoke"})
    raw = (tmp_path / "step_00000003" / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(raw)
    assert len(manifest["leaves"]) == 3 * 13 + 1
    assert port_msgpack.packb(manifest) == msgpack.packb(manifest) == raw
    assert port_msgpack.unpackb(raw) == manifest


def test_msgpack_subset_refuses_what_it_does_not_take():
    with pytest.raises(TypeError):
        port_msgpack.packb({1.5j: 1})
    with pytest.raises(ValueError, match="not in the subset"):
        port_msgpack.unpackb(b"\xc7\x01\x00\x00")     # ext 8
    with pytest.raises(ValueError, match="ends early"):
        port_msgpack.unpackb(b"\xa5abc")
    with pytest.raises(ValueError, match="extra data"):
        port_msgpack.unpackb(b"\x01\x02")


def test_checkpoints_need_no_msgpack_or_ml_dtypes(tmp_path):
    """A fresh interpreter where importing msgpack or ml_dtypes fails saves
    and restores a bf16 and fp32 tree through the port."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.ckpt import save, restore\n"
        "t = {'a': torch.arange(6, dtype=torch.bfloat16) / 3,\n"
        "     'b': [torch.ones(2, 3), torch.tensor(4, dtype=torch.int32)]}\n"
        f"save({str(tmp_path)!r}, 2, t, meta={{'arch': 'x'}})\n"
        f"got, m = restore({str(tmp_path)!r}, t, device='cpu')\n"
        "assert m['step'] == 2 and m['meta'] == {'arch': 'x'}\n"
        "assert torch.equal(got['a'], t['a']) and got['a'].dtype == t['a'].dtype\n"
        "assert all(torch.equal(x, y) for x, y in zip(got['b'], t['b']))\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

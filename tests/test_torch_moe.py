"""The port's MoE (``models/mlp.py``) against the JAX package's, on the CPU.

Reduced moonshot-v1-16b-a3b and mixtral-8x22b (both 4 experts, top 2
after ``reduced()``) and reduced moonshot with 16 experts, top 6 (the sum
of six expert rows per token), the JAX package's own initialised
expert weights carried across by ``repro_torch.convert``, inputs from a
numpy seed. Both dtypes, both capacities: ``inference`` (drop-free, as
decode runs it) and the capacity factor's (as prefill and training run
it), plus a drop case at capacity factor 1.0 where JAX's own ``keep`` mask
drops slots, so a wrong sort order changes which tokens an expert keeps.

Tolerances: fp32 outputs within 1e-5 of the output's largest magnitude
(the same products in another summation order) and the aux loss within
1e-5 relative. bf16 within twice JAX's own bf16 deviation from its fp32
result on the same bf16-rounded inputs and weights: the port's bf16
output must be no further from that fp32 result than twice JAX's bf16
output is.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mlp as JMLP
from repro_torch import convert
from repro_torch.configs import ArchConfig
from repro_torch.models import mlp as TMLP

ARCHS = ["moonshot_v1_16b_a3b", "mixtral_8x22b", "moonshot_v1_16b_a3b-wide"]
# reduced() leaves both archs 4 experts, top 2; "-wide" keeps more of
# moonshot's routing: 16 experts, top 6 (six rows summed per token)
WIDE = {"n_experts": 16, "top_k": 6}
FP32_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, **kw):
    if arch.endswith("-wide"):
        arch, kw = arch.removesuffix("-wide"), {**WIDE, **kw}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               param_dtype="float32", remat="none", **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, dtype):
    """JAX's init (the router fp32, experts in ``dtype``) and its copy."""
    jp = JMLP.init_moe_params(jax.random.PRNGKey(7), jcfg, dtype)
    return jp, convert.to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) \
        else a.float().numpy()


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _check_fp32(got, want):
    (y, aux), (jy, jaux) = got, want
    scale = float(np.abs(_np(jy)).max())
    assert _max_diff(y, jy) <= FP32_TOL * scale, (_max_diff(y, jy), scale)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=FP32_TOL)


def _run(jcfg, tcfg, x, dtype, inference):
    jdt, tdt = DTYPES[dtype]
    jp, tp = _params(jcfg, jdt)
    jx = jnp.asarray(x).astype(jdt)
    want = JMLP.moe_forward(jp, jcfg, jx, inference=inference)
    tx = torch.from_numpy(x).to(tdt)
    got = TMLP.moe_forward(tp, tcfg, tx, inference=inference)
    again = TMLP.moe_forward(tp, tcfg, tx, inference=inference)
    assert got[0].dtype == tdt and got[0].shape == tx.shape
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    return jp, jx, want, got


@pytest.mark.parametrize("inference", [False, True],
                         ids=["capacity", "dropfree"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, dtype, inference):
    jcfg, tcfg = _cfgs(arch)
    x = _x((2, 16, jcfg.d_model))
    jp, jx, want, got = _run(jcfg, tcfg, x, dtype, inference)
    if dtype == "float32":
        _check_fp32(got, want)
        return
    # JAX's fp32 result on the same bf16-rounded inputs and weights
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    ref, ref_aux = JMLP.moe_forward(jp32, jcfg, jx.astype(jnp.float32),
                                    inference=inference)
    jax_dev = _max_diff(want[0], ref)
    assert 0 < jax_dev and _max_diff(got[0], ref) <= 2 * jax_dev, (
        _max_diff(got[0], ref), jax_dev)
    aux_dev = abs(float(want[1]) - float(ref_aux))
    assert abs(float(got[1]) - float(ref_aux)) <= 2 * aux_dev + 1e-7


def _jax_routing(jp, jcfg, jx):
    """Slots per expert and the capacity, as ``repro/models/mlp.py`` routes
    ``jx`` with ``inference=False``."""
    N = jx.shape[0] * jx.shape[1]
    xf = jx.reshape(N, -1)
    logits = jnp.dot(xf, jp["router"].astype(xf.dtype),
                     preferred_element_type=jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    counts = np.bincount(np.asarray(top_e).reshape(-1),
                         minlength=jcfg.n_experts)
    C = int(max(1, round(N * jcfg.top_k / jcfg.n_experts
                         * jcfg.capacity_factor)))
    return counts, min(C, N)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_past_capacity_like_jax(arch):
    """Capacity factor 1.0 and 64 tokens: JAX's ``keep`` mask drops the
    slots past each full expert's capacity (asserted, so this case sees the
    sort order), and the port drops the same ones."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    x = _x((2, 32, jcfg.d_model), seed=11)
    jp, jx, want, got = _run(jcfg, tcfg, x, "float32", inference=False)
    counts, C = _jax_routing(jp, jcfg, jx)
    assert C == TMLP.capacity(tcfg, 64, inference=False)
    assert counts.max() > C, counts                   # JAX drops slots
    _check_fp32(got, want)
    dropfree = TMLP.moe_forward(convert.to_torch(jax.tree_util.tree_map(
        np.asarray, jp), device="cpu"), tcfg, torch.from_numpy(x),
        inference=True)[0]
    assert _max_diff(dropfree, got[0]) > 100 * FP32_TOL * float(
        np.abs(_np(want[0])).max())                   # the drops show


@pytest.mark.parametrize("n,factor,want", [(5, 1.0, 2), (7, 1.0, 4),
                                           (64, 1.0, 32), (6, 1.25, 4),
                                           (1, 0.01, 1), (3, 4.0, 3)])
def test_capacity_rounds_half_to_even(n, factor, want):
    """``int(max(1, round(N * K / E * factor)))`` capped at N, with
    Python's round, half to even: K / E = 2 / 4 here, so N = 5 gives 2.5
    -> 2 and N = 7 gives 3.5 -> 4; at least 1, at most N."""
    _, tcfg = _cfgs("mixtral_8x22b", capacity_factor=factor)
    assert TMLP.capacity(tcfg, n, inference=False) == want
    assert TMLP.capacity(tcfg, n, inference=True) == n


def test_init_moe_params_shapes_and_dtypes():
    """The router stays fp32 in a bf16 model; experts are stacked
    ``[L, E, d, f]`` / ``[L, E, f, d]`` like the JAX tree."""
    _, tcfg = _cfgs("moonshot_v1_16b_a3b")
    p = TMLP.init_moe_params(torch.Generator().manual_seed(0), tcfg,
                             torch.bfloat16, "cpu", lead=(3,))
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    assert p["router"].shape == (3, d, E) and p["router"].dtype == torch.float32
    assert p["w_up"].shape == p["w_gate"].shape == (3, E, d, f)
    assert p["w_down"].shape == (3, E, f, d)
    assert all(p[k].dtype == torch.bfloat16 for k in ("w_up", "w_gate",
                                                       "w_down"))
    assert abs(float(p["w_up"].float().std()) * d ** 0.5 - 1) < 0.05


# --------------------------------------------------------------------------
# chip_smoke.py's router comparison (the layer check of an MoE model)
# --------------------------------------------------------------------------
def test_chip_smoke_router_flips_counts_choices_and_margins():
    """``router_flips`` on a router whose logits are its input (identity,
    4 experts, top 2): token 0's second and third experts trade places
    between the kernel and the plain input, token 1 routes alike; one
    (token, k) choice differs, its plain margin is the gap it crossed
    (1.0) and the rounding is the plain logits' distance from the fp32
    ones (0.25)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = jax_get_config("moonshot_v1_16b_a3b").reduced()
    assert (cfg.n_experts, cfg.top_k) == (4, 2)
    plain = torch.tensor([[[3.0, 2.0, 1.0, 0.0], [0.0, 1.0, 2.0, 3.0]]])
    kernel = torch.tensor([[[3.0, 1.0, 2.0, 0.0], [0.0, 1.0, 2.0, 3.0]]])
    x32 = plain + 0.25
    n, total, margins, roundings = smoke.router_flips(
        torch.eye(4), cfg, kernel.to(torch.bfloat16),
        plain.to(torch.bfloat16), x32)
    assert (n, total) == (1, 4)
    assert margins == [1.0] and roundings == [0.25]

"""Dense gated MLP (SwiGLU for qwen3): the counterpart of the dense half of
``repro/models/mlp.py``. The ungated form and MoE are not ported yet."""
from __future__ import annotations

from .common import activation_fn, dense_init, matmul


def init_mlp_params(generator, cfg, dtype, device, lead=()):
    if not cfg.gated_mlp:
        raise NotImplementedError("the ungated MLP is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(generator, d, f, dtype, device, lead=lead),
            "w_down": dense_init(generator, f, d, dtype, device, lead=lead),
            "w_gate": dense_init(generator, d, f, dtype, device, lead=lead)}


def mlp_forward(p, cfg, x):
    act = activation_fn(cfg.activation)
    up = matmul(x, p["w_up"])
    h = act(matmul(x, p["w_gate"]).float()).to(x.dtype) * up
    return matmul(h, p["w_down"])

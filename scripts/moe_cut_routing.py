#!/usr/bin/env python3
"""Where moonshot-v1-16b-a3b's fp32 depth cuts of 4 and of 5 layers part
ways, on one CUDA card, in a few minutes of command with the build.

    python3 scripts/moe_cut_routing.py [--cuts 4 5]

``chip_smoke.py``'s phase 5f holds the kernel path's teacher-forced logits
on a depth cut of the model to twice that cut's bf16 noise floor (the
plain bf16 path's distance from the plain fp32 one). This script draws the
model as that phase does (48 layers at full width, seed 0), takes the
phase's first prompt (1291 tokens) and, for each cut k (the first k layers,
the same embed and head):

1. the prefill's last-position logits through the kernels, the plain
   versions in bf16 and the plain versions with fp32 weights: kernel vs
   plain and plain vs fp32 (the floor) max |diff|, and each path's token;
2. the same prefill layer by layer, each path on its own input: max |h|
   distance of kernel vs plain and plain vs fp32 after each layer, and the
   router choices in which the kernel path and the plain path differ at
   that layer (``router_flips``: the plain router's margin between the
   swapped experts beside its bf16 rounding there; a margin within twice
   the rounding is a tie, the layer check's rule), with the positions of
   the tokens they fall on;
3. ``check_layers`` on the cut (each layer on the kernel path's own input,
   router choices logged per layer), as phase 5f runs it at full depth;
   its verdict is printed, not raised.

Ends with "probe ok" unless a step could not run.
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.blocks import block_forward  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import embed_tokens, lm_logits  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"


def layer_walk(params, cfg, prompt):
    """The prefill of ``prompt`` layer by layer through the kernels, the
    plain versions (bf16) and the plain versions with fp32 weights, each
    on its own input; per layer the hidden states' distances and the
    router choices the kernel and plain paths differ in. Returns the
    last position's logits of the three paths."""
    kind, stage = cfg.block_pattern[0], params["stages"][0]
    dev = params["embed"].device
    toks = torch.as_tensor(prompt[None], device=dev)
    pos = torch.arange(toks.shape[1], device=dev)[None]
    with torch.no_grad():
        h = embed_tokens(params, cfg, toks)
        hk, hp, h32 = h, h, h.float()
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], stage)
            lp32 = tree_map(lambda t: t.float(), lp)
            xk, xp, x32 = [], [], []
            with cs.router_inputs(xk):
                hk, _ = block_forward(kind, lp, cfg, hk, pos=pos)
            with cs.plain_versions():
                with cs.router_inputs(xp):
                    hp, _ = block_forward(kind, lp, cfg, hp, pos=pos)
                with cs.router_inputs(x32):
                    h32, _ = block_forward(kind, lp32, cfg, h32, pos=pos)
            n, total, margins, roundings = cs.router_flips(
                lp["moe"]["router"], cfg, xk[0], xp[0], x32[0])
            lk = cs.matmul(xk[0].reshape(-1, cfg.d_model),
                           lp["moe"]["router"], out_dtype=torch.float32)
            lpl = cs.matmul(xp[0].reshape(-1, cfg.d_model),
                            lp["moe"]["router"], out_dtype=torch.float32)
            top = lambda lg: lg.topk(cfg.top_k, dim=-1).indices.sort().values
            rows = (top(lk) != top(lpl)).any(-1).nonzero()[:, 0].tolist()
            ties = sum(m <= 2 * r for m, r in zip(margins, roundings))
            cs.log(f"  layer {i}: max|h| kernel vs plain "
                   f"{float((hk.float() - hp.float()).abs().max()):.4e}, "
                   f"plain vs fp32 "
                   f"{float((hp.float() - h32).abs().max()):.4e}; router "
                   f"choices differing {n} of {total} at positions "
                   f"{rows[:16]}{' ...' if len(rows) > 16 else ''} "
                   f"({ties} ties); (margin, rounding) "
                   + ", ".join(f"({m:.3e}, {r:.3e})"
                               for m, r in list(zip(margins, roundings))[:8]))
            del xk, xp, x32, lp32
        last = lambda p, h: lm_logits(p, cfg, h[:, -1:])[0, 0].float()
        params32 = {k: v for k, v in params.items() if k != "stages"}
        params32 = tree_map(lambda t: t.float(), params32)
        out = last(params, hk)
        with cs.plain_versions():
            out = (out, last(params, hp), last(params32, h32))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cuts", type=int, nargs="+", default=[4, 5])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_cut_routing: no CUDA card visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}")
    build.load()
    cfg = get_config(ARCH)
    full = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                       device="cuda")
    rng = np.random.default_rng(0)              # serve()'s prompts
    lens = rng.integers(100, 1501, size=8)
    prompt = rng.integers(0, cfg.vocab_size, lens[0])
    cs.log(f"{ARCH}: {sum(t.numel() for t in tree_leaves(full)) / 1e9:.3f} "
           f"B params; prompt of {len(prompt)} tokens")
    view, base_cfg = cs.depth_cut(full, cfg, max(args.cuts))
    base = tree_map(lambda t: t.clone(), view)  # the rest of the model goes
    del view, full
    gc.collect()
    torch.cuda.empty_cache()
    for k in args.cuts:
        params, cut = cs.depth_cut(base, base_cfg, k)
        cs.log(f"cut of {k} layers:")
        with torch.no_grad():
            got = cs.teacher_forced(params, cut, prompt, [])[0]
            with cs.plain_versions():
                plain = cs.teacher_forced(params, cut, prompt, [])[0]
                ref32 = cs.teacher_forced(tree_map(lambda t: t.float(),
                                                   params), cut, prompt,
                                          [])[0]
        diff = float((got - plain).abs().max())
        floor = float((plain - ref32).abs().max())
        cs.log(f"  prefill logits: kernel vs plain {diff:.4e}, plain vs "
               f"fp32 (floor) {floor:.4e}, ratio {diff / floor:.3f} (phase "
               f"5f's tol 2); tokens kernel {int(got.argmax())}, plain "
               f"{int(plain.argmax())}, fp32 {int(ref32.argmax())}")
        wk, wp, w32 = layer_walk(params, cut, prompt)
        cs.log(f"  layer walk's last logits: kernel vs plain "
               f"{float((wk - wp).abs().max()):.4e}, plain vs fp32 "
               f"{float((wp - w32).abs().max()):.4e}; same as the prefill's: "
               f"kernel {float((wk - got).abs().max()):.4e}, plain "
               f"{float((wp - plain).abs().max()):.4e}")
        try:
            cs.check_layers(params, cut, prompt, 2)
            cs.log(f"  check_layers on the {k}-layer cut: passed")
        except RuntimeError as e:
            cs.log(f"  check_layers on the {k}-layer cut: FAILED: {e}")
        del params, got, plain, ref32
        gc.collect()
        torch.cuda.empty_cache()
    cs.log("probe ok")


if __name__ == "__main__":
    main()

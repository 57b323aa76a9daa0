"""Model assembly of the port: stages, init, forward, prefill and decode
(counterpart of ``repro/models/model.py`` for stacks of ATTN, MOE, MAMBA2,
MLSTM and SLSTM blocks: qwen3, qwen2, moonshot, mixtral, xlstm, zamba2,
qwen2-vl and whisper).

Params keep the JAX package's tree: ``{"embed", "final_norm", "stages":
[...]}`` with each stage's blocks stacked on a leading layer axis, so
``repro_torch.convert`` carries weights across without reshaping. Where
JAX scans a stage, the port loops over its layers. The serving cache is
``{"stages": [...]}``, one tree per stage whose leaves put the layer axis
first and batch at dim 1: ``{"kv": (k, v)}`` of ``[L, B, S, KV, hd]`` for
ATTN and MOE (S is the window for a sliding-window model: a rolling
cache, ``kv_cache_size``), the recurrent state (``[L, B, ...]``) for
MAMBA2, MLSTM and SLSTM.

zamba2 adds one shared ATTN block, ``p["shared"]`` (unstacked: its weights
serve every application), applied after every stage (stages are cut at
multiples of ``shared_attn_every``). Its cache ``cache["shared"]`` holds one
KV cache per application, ``{"kv": (k, v)}`` of ``[n_app, B, S, KV, hd]``.

The two stub frontends are the JAX package's: qwen2-vl's patch embeddings
are set into the token stream at ``patch_pos`` and its M-RoPE takes
``pos3`` [3, B, T] (t, h, w ids); whisper's frames [B, enc_len, d] go
through ``encode`` (``p["encoder"]``, ATTN blocks stacked on a layer axis,
non-causal, then ``p["enc_norm"]``), its decoder blocks attend to the
encoder's output and keep its k, v as ``xkv`` (``[L, B, enc_len, KV,
hd]``) in their caches, and its positions are sinusoids added to the
embeddings (``rope_theta == 0``). ``prefill`` takes these inputs by
keyword; ``decode_step`` needs none of them (M-RoPE decodes at
``cache_len`` on all three axes, as the JAX package's).

``forward_hidden`` wraps each stage layer in ``cfg.remat``, as the
reference's ``_remat_wrap`` does (``repro/models/model.py:107-115``), with
``torch.utils.checkpoint`` in its non-reentrant form: ``full`` keeps only
each block's input and recomputes the block in the backward, so under it
every kernel forward of a block (flash attention, the norms) launches twice
per backward pass; ``dots`` keeps the outputs of the matrix products
without batch dims (``aten.mm``/``addmm``: the projections, as JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .blocks import (block_decode, block_forward, block_prefill, init_block,
                     init_block_cache)
from .common import (dtype_of, embed_init, is_meta, matmul, rms_norm,
                     sinusoid_at, sinusoidal_positions, tree_leaves, tree_map)


def pattern_stages(cfg) -> List[Tuple[str, int]]:
    """[(kind, count), ...] — runs of equal kind, cut at shared-attn bounds."""
    stages: List[Tuple[str, int]] = []
    for i, kind in enumerate(cfg.block_pattern):
        cut = (cfg.shared_attn_every
               and i % cfg.shared_attn_every == 0 and i > 0)
        if stages and stages[-1][0] == kind and not cut:
            stages[-1] = (kind, stages[-1][1] + 1)
        else:
            stages.append((kind, 1))
    return stages


def n_shared_applications(cfg) -> int:
    """Shared attention applies once after every stage (stages are cut at
    multiples of shared_attn_every), so count = number of stages."""
    if not cfg.shared_attn_every:
        return 0
    return len(pattern_stages(cfg))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked stage (views, so in-place updates land in
    the stack)."""
    return tree_map(lambda x: x[i], tree)


def _layers(tree, count: int):
    """Every layer of a stacked stage, as views from one ``unbind`` per
    leaf: autograd then stacks each leaf's gradient once, where indexing
    layer by layer would add a zero-filled copy of the stack per layer."""
    parts = [x.unbind(0) for x in tree_leaves(tree)]
    layers = []
    for i in range(count):
        leaf = iter(parts)
        layers.append(tree_map(lambda _: next(leaf)[i], tree))
    return layers


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg):
    """``fn`` (a block forward) under ``cfg.remat``: ``none``, ``dots`` or
    ``full``. The blocks draw no random numbers, so no RNG state is kept.
    Without autograd (``prefill``'s encoder) there is nothing to keep for
    a backward and ``fn`` runs as it is: the first ``checkpoint`` call of a
    process also imports ``torch._dynamo``, seconds on the host."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat {cfg.remat!r}: takes none, dots or full")
    extra = ({"context_fn": lambda: create_selective_checkpoint_contexts(
        _save_dots)} if cfg.remat == "dots" else {})

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)
    return wrapped


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random params with the JAX package's distributions, drawn from
    ``generator`` on its own device and placed on ``device``. On the
    ``meta`` device (``repro.models.abstract_params``'s counterpart) every
    leaf has its shape and dtype and no storage, nothing is drawn, and
    ``generator`` may be None."""
    if generator is None and not is_meta(device):
        raise ValueError("init_params: a generator is needed off the meta "
                         "device")
    dtype = dtype_of(cfg.param_dtype)
    p: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, device)
    p["final_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=device)
    p["stages"] = [init_block(kind, generator, cfg, dtype, device,
                              lead=(count,), cross=cfg.enc_dec)
                   for kind, count in pattern_stages(cfg)]
    if cfg.shared_attn_every:
        p["shared"] = init_block("attn", generator, cfg, dtype, device)
    if cfg.enc_dec:
        p["encoder"] = init_block("attn", generator, cfg, dtype, device,
                                  lead=(cfg.n_enc_layers,))
        p["enc_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=device)
    return p


def _absolute_positions(cfg) -> bool:
    """Sinusoids added to the embeddings (whisper), where no RoPE runs."""
    return cfg.rope_theta == 0 and not cfg.mrope_sections


def embed_tokens(p, cfg, tokens, patch_embeds=None, patch_pos=None):
    """The embedding rows of ``tokens``, with ``patch_embeds`` [B, P, d]
    set at ``patch_pos`` [B, P] (qwen2-vl's stub frontend) and sinusoidal
    positions added (whisper). ``F.embedding`` and not indexing: the
    backward of ``embed[tokens]`` on a CPU tensor is an index_put with
    accumulate, whose threads add into shared rows in no fixed order, so
    two identical steps could differ in the last bit; the embedding's
    backward sums each row in a fixed order on the CPU and the card."""
    h = F.embedding(tokens, p["embed"])
    if patch_embeds is not None:
        rows = torch.arange(h.shape[0], device=h.device)[:, None]
        h = h.index_put((rows, patch_pos), patch_embeds.to(h.dtype))
    if _absolute_positions(cfg):
        h = h + sinusoidal_positions(h.shape[1], cfg.d_model,
                                     h.device).to(h.dtype)[None]
    return h


def lm_logits(p, cfg, h):
    """bf16 logits, as ``repro/models/model.py:182-185``."""
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"].T
    return matmul(rms_norm(h, p["final_norm"], cfg.norm_eps), w,
                  out_dtype=torch.bfloat16)


def _positions(B: int, T: int, device):
    return torch.arange(T, device=device)[None].expand(B, T)


def encode(p, cfg, frames):
    """frames [B, S_enc, d] (the stub frontend's embeddings) -> the
    encoder's output: sinusoids added, the non-causal ATTN blocks of
    ``p["encoder"]`` (under ``cfg.remat``), then ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames "
                         "[B, enc_len, d]")
    B, S = frames.shape[:2]
    h = frames + sinusoidal_positions(S, cfg.d_model,
                                      frames.device).to(frames.dtype)[None]
    pos = _positions(B, S, frames.device)
    block = _remat_wrap(block_forward, cfg)
    for layer in _layers(p["encoder"], cfg.n_enc_layers):
        h, _ = block("attn", layer, cfg, h, pos=pos, causal=False)
    return rms_norm(h, p["enc_norm"], cfg.norm_eps)


def forward_hidden(p, cfg, tokens, *, pos=None, pos3=None, enc_out=None,
                   patch_embeds=None, patch_pos=None):
    """tokens [B, T] -> (hidden [B, T, d], aux)."""
    B, T = tokens.shape
    pos = _positions(B, T, tokens.device) if pos is None else pos
    h = embed_tokens(p, cfg, tokens, patch_embeds, patch_pos)
    aux = torch.zeros((), device=h.device)
    block = _remat_wrap(block_forward, cfg)
    for (kind, count), stage in zip(pattern_stages(cfg), p["stages"]):
        for layer in _layers(stage, count):
            h, a = block(kind, layer, cfg, h, pos=pos, pos3=pos3,
                         enc_out=enc_out)
            aux = aux + a
        if cfg.shared_attn_every:
            h, a = block_forward("attn", p["shared"], cfg, h, pos=pos)
            aux = aux + a
    return h, aux


def forward_loss(p, cfg, batch):
    """batch: {tokens [B,T], labels [B,T] (-1 = ignore), + the modality
    inputs: frames (whisper), pos3, patch_embeds, patch_pos (qwen2-vl)} ->
    (loss, metrics),
    as ``repro/models/model.py:230-258``: bf16 logits, the next-token
    shift, and the lse and the target logit taken in fp32 from the bf16
    logits. Each takes its own fp32 copy, as JAX's two ``astype`` do, so
    each path's gradient is rounded to bf16 on its own before the two are
    added (one shared copy would add them in fp32 first)."""
    tokens, labels = batch["tokens"], batch["labels"]
    enc_out = encode(p, cfg, batch.get("frames")) if cfg.enc_dec else None
    h, aux = forward_hidden(p, cfg, tokens, pos3=batch.get("pos3"),
                            enc_out=enc_out,
                            patch_embeds=batch.get("patch_embeds"),
                            patch_pos=batch.get("patch_pos"))
    logits = lm_logits(p, cfg, h)[:, :-1]                 # [B, T-1, V] bf16
    targets = labels[:, 1:]
    mask = (targets >= 0).float()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits.float(), -1,
                       targets.clamp_min(0)[..., None].long())[..., 0]
    nll = (lse - tgt) * mask
    loss = nll.sum() / mask.sum().clamp_min(1.0)
    metrics = {"nll": loss, "aux": aux, "ntokens": mask.sum()}
    return loss + aux, metrics


def kv_cache_size(cfg, seq_len: int) -> int:
    """KV slots for ``seq_len`` positions: the window for a sliding-window
    model (a rolling cache, slot = position % window), else ``seq_len``."""
    return cfg.sliding_window or seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype=None, device="cuda"):
    dtype = dtype or dtype_of(cfg.param_dtype)
    size = kv_cache_size(cfg, seq_len)
    cache = {"stages": [init_block_cache(kind, cfg, batch, size, dtype,
                                         device, lead=(count,),
                                         cross=cfg.enc_dec,
                                         enc_len=cfg.enc_len)
                        for kind, count in pattern_stages(cfg)]}
    if cfg.shared_attn_every:
        cache["shared"] = init_block_cache(
            "attn", cfg, batch, size, dtype, device,
            lead=(n_shared_applications(cfg),))
    return cache


@torch.no_grad()
def prefill(p, cfg, tokens, *, pos3=None, frames=None, patch_embeds=None,
            patch_pos=None, pad: int = 64):
    """Process the prompt; returns (last-position logits [B, V], cache).

    ``pos3`` [3, B, T] (M-RoPE), ``patch_embeds`` / ``patch_pos`` (the
    VLM stub frontend) and ``frames`` (the encoder's input) as
    ``forward_hidden`` and ``encode`` take them. ``pad`` — extra KV slots
    reserved for tokens generated after prefill (ignored for a rolling
    sliding-window cache). Runs without autograd, as ``decode_step`` does:
    JAX keeps no tape, and params left requiring grad must not chain each
    step's graph onto the cache.
    """
    B, T = tokens.shape
    pos = _positions(B, T, tokens.device)
    enc_out = encode(p, cfg, frames) if cfg.enc_dec else None
    h = embed_tokens(p, cfg, tokens, patch_embeds, patch_pos)
    size = kv_cache_size(cfg, T) if cfg.sliding_window else T + pad
    stack = lambda caches: tree_map(lambda *xs: torch.stack(xs), *caches)
    caches, shared = [], []
    for (kind, count), stage in zip(pattern_stages(cfg), p["stages"]):
        layer_caches = []
        for i in range(count):
            h, c = block_prefill(kind, _layer(stage, i), cfg, h, pos=pos,
                                 pos3=pos3, enc_out=enc_out, cache_size=size)
            layer_caches.append(c)
        caches.append(stack(layer_caches))
        if cfg.shared_attn_every:
            h, c = block_prefill("attn", p["shared"], cfg, h, pos=pos,
                                 cache_size=size)
            shared.append(c)
    cache = {"stages": caches}
    if shared:
        cache["shared"] = stack(shared)
    logits = lm_logits(p, cfg, h[:, -1:])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(p, cfg, token, cache, cache_len):
    """One token for every sequence. token: [B]; cache_len: a scalar or a
    per-row [B] tensor. Updates ``cache`` in place; returns (logits [B, V],
    cache). The shared block's applications write their own KV caches
    through views of ``cache["shared"]``. Whisper adds the sinusoid of
    position ``cache_len`` to the token's embedding."""
    rolling = cfg.sliding_window > 0
    h = F.embedding(token[:, None], p["embed"])
    if _absolute_positions(cfg):
        cl = torch.as_tensor(cache_len, device=h.device).expand(h.shape[0])
        h = h + sinusoid_at(cl, cfg.d_model).to(h.dtype)[:, None]
    for app, ((kind, count), stage, stage_cache) in enumerate(zip(
            pattern_stages(cfg), p["stages"], cache["stages"])):
        for i in range(count):
            h, _ = block_decode(kind, _layer(stage, i), cfg, h,
                                _layer(stage_cache, i), cache_len=cache_len,
                                rolling=rolling)
        if cfg.shared_attn_every:
            h, _ = block_decode("attn", p["shared"], cfg, h,
                                _layer(cache["shared"], app),
                                cache_len=cache_len, rolling=rolling)
    logits = lm_logits(p, cfg, h)
    return logits[:, 0], cache

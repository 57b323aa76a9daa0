"""Serving runtime of the port: continuous batching over a fixed slot pool
(counterpart of ``repro/serve/engine.py``, same API and semantics).

  submit()  — queue a prompt
  tick()    — admit queued requests into free slots (exact-length prefill
              per request, its cache copied into the slot), then one batched
              decode step for every active slot; finished sequences free
              their slots.

Per-slot cache lengths make heterogeneous prompt lengths exact. The cache
holds ``kv_cache_size(cfg, max_seq)`` slots a layer: ``max_seq``, or for a
sliding-window model (mixtral) its window, a rolling cache that serves
prompts longer than the window. Slots that
are not active still decode (cache_len 0, a stale token) and their output is
ignored; admission overwrites the whole slot. PyTorch runs eagerly, so there
is no per-length compile cache to keep. ``stats`` adds the wall seconds
spent in prefill and in decode (each ends when the chosen tokens reach the
host, so the device work is inside them). Admission and decoding run under
``torch.no_grad``, so params that require grad record no graph. An arch
whose prefill needs more than tokens (whisper's frames, qwen2-vl's M-RoPE
ids) raises at construction: requests carry tokens only, and the JAX
package's engine cannot serve these archs either.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.common import tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 32
    eos: int = -1
    tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


def _insert_slot(cache, slot_cache, idx: int):
    """Copy a single-request cache (B=1) into slot ``idx`` of the batched
    cache, in place. Every leaf has batch at dim 1: [L, B, ...] for a
    stage, [n_app, B, ...] for zamba2's shared block; a rolling cache has
    the window's slots on both sides."""
    tree_map(lambda big, one: big[:, idx].copy_(one[:, 0]), cache, slot_cache)


class ServeEngine:
    def __init__(self, cfg, params, slots: int = 8, max_seq: int = 2048,
                 greedy: bool = True, seed: int = 0, device="cuda"):
        needs = (["frames"] if cfg.enc_dec else []) + (
            ["pos3"] if cfg.mrope_sections else [])
        if needs:
            raise NotImplementedError(
                f"ServeEngine: {cfg.name}'s prefill needs {' and '.join(needs)}"
                ", which requests do not carry; serve it through "
                "repro_torch.models.prefill(..., "
                + ", ".join(f"{n}=..." for n in needs)
                + ") and decode_step")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine: device 'cuda' asked for but no "
                               "CUDA card is available (pass device='cpu')")
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.cache = init_cache(cfg, slots, max_seq, device=self.device)
        self.cache_len = np.zeros((slots,), np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.next_token = np.zeros((slots,), np.int64)
        self._rid = 0
        self.stats = {"decode_steps": 0, "prefills": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int = 32, eos: int = -1) -> int:
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1 or not 1 <= len(prompt) <= self.max_seq:
            raise ValueError(f"prompt must be 1-d with 1..{self.max_seq} "
                             f"tokens, got shape {prompt.shape}")
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, prompt, max_new, eos,
                                  submitted_at=time.monotonic()))
        return rid

    @torch.no_grad()
    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            L = len(req.prompt)
            t0 = time.perf_counter()
            toks = torch.as_tensor(req.prompt[None, :], device=self.device)
            logits, c1 = prefill(self.params, self.cfg, toks,
                                 pad=self.max_seq - L)
            nxt = int(torch.argmax(logits[0]))
            self.stats["prefill_s"] += time.perf_counter() - t0
            req.tokens.append(nxt)
            req.first_token_at = time.monotonic()
            self.stats["prefills"] += 1
            if nxt == req.eos or len(req.tokens) >= req.max_new:
                # finished at the first token: never occupies a slot
                req.done_at = time.monotonic()
                self.done[req.rid] = req
                continue
            _insert_slot(self.cache, c1, slot)
            self.active[slot] = req
            self.cache_len[slot] = L
            self.next_token[slot] = nxt

    def _choose(self, logits):
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tick(self):
        """Admit + one decode step across all active slots."""
        self._admit()
        if not any(r is not None for r in self.active):
            return False
        t0 = time.perf_counter()
        logits, self.cache = decode_step(
            self.params, self.cfg,
            torch.as_tensor(self.next_token, device=self.device), self.cache,
            torch.as_tensor(self.cache_len, device=self.device))
        nxt = self._choose(logits).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.cache_len[slot] += 1
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.next_token[slot] = tok
            if tok == req.eos or len(req.tokens) >= req.max_new:
                req.done_at = time.monotonic()
                self.done[req.rid] = req
                self.active[slot] = None
                self.cache_len[slot] = 0
        return True

    def run(self, max_ticks: int = 10_000):
        while (self.queue or any(r is not None for r in self.active)) \
                and max_ticks > 0:
            self.tick()
            max_ticks -= 1
        return self.done

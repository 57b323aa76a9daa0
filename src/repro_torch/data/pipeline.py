"""Data pipeline: the port's own copy of ``repro.data.pipeline`` (the JAX
package's module is framework-neutral, but the port imports nothing of
``repro``): a deterministic synthetic stream and a packed binary corpus.

Both sources are stateless by step index: ``batch(step)`` is a pure
function of (seed, step), drawn with numpy's counter-based Philox
generator, so both packages give the same batches bit for bit and a
restarted trainer re-reads the same data. ``PackedBinReader`` and
``make_batch_fn`` are copied verbatim. ``SyntheticLM`` leaves out the
reference's ``num_hosts``/``host_id`` row partition: the port runs on one
host, so it always returns the whole global batch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class SyntheticLM:
    """Uniform random tokens; labels are the tokens (the loss shifts them)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=step))
        tokens = rng.integers(0, self.vocab_size,
                              size=(self.global_batch, self.seq_len),
                              dtype=np.int32)
        return {"tokens": tokens, "labels": tokens.copy()}


class PackedBinReader:
    """Memmap'd packed-token corpus (.bin of uint16/uint32).

    Sampling is deterministic in (seed, step): window offsets are drawn from
    a counter-based RNG, so restart/rescale re-reads identical data.
    """

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.uint16, seed: int = 0, num_hosts: int = 1,
                 host_id: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.n_tokens = len(self.data)
        if self.n_tokens < seq_len + 1:
            raise ValueError(f"corpus too small: {self.n_tokens} tokens")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=step))
        B, T = self.global_batch, self.seq_len
        offs = rng.integers(0, self.n_tokens - T - 1, size=B)
        lo = B * self.host_id // self.num_hosts
        hi = B * (self.host_id + 1) // self.num_hosts
        rows = [np.asarray(self.data[o:o + T], dtype=np.int32)
                for o in offs[lo:hi]]
        arr = np.stack(rows)
        # contract: labels == tokens; forward_loss applies the next-token
        # shift internally (targets = labels[:, 1:] vs logits[:, :-1]).
        return {"tokens": arr, "labels": arr.copy()}

    @staticmethod
    def write_corpus(path: str, tokens: np.ndarray, dtype=np.uint16):
        np.asarray(tokens, dtype=dtype).tofile(path)


def make_batch_fn(cfg, shape, seed: int = 0, corpus: Optional[str] = None):
    """Returns batch(step) for (arch cfg, ShapeConfig)."""
    if corpus and os.path.exists(corpus):
        src = PackedBinReader(corpus, shape.seq_len, shape.global_batch,
                              seed=seed)
    else:
        src = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                          seed=seed)

    def fn(step: int):
        b = src.batch(step)
        # labels shifted inside forward_loss; keep identical copies here
        return b

    return fn

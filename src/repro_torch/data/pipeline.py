"""Deterministic synthetic token stream: the port's own copy of
``repro.data.pipeline.SyntheticLM`` (the JAX package's module is
framework-neutral, but the port imports nothing of ``repro``).

``batch(step)`` is a pure function of (seed, step), drawn with numpy's
counter-based Philox generator, so both packages give the same batches bit
for bit. The port runs on one host, so this copy always returns the whole
global batch (the reference's ``num_hosts``/``host_id`` row partition is
left out), and the packed binary corpus reader is not copied yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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

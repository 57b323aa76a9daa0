"""nemotron-4-340b [dense] — GQA 96:8, hd 192, squared-ReLU (ungated MLP),
untied vocabulary of 256000. [arXiv:2402.16819]

A copy of ``repro/configs/nemotron_4_340b.py``. The sharding fields
(``fsdp``, ``seq_parallel``, ``microbatches``, bf16 optimizer moments) are
the JAX package's TPU layout; the port runs one card and reads none of them.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    gated_mlp=False,
    rope_theta=10_000.0,
    opt_state_dtype="bfloat16",
    microbatches=16,
    fsdp=True,
    seq_parallel=True,
)

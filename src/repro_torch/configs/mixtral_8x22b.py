"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

SWA (window 4096) -> rolling KV cache -> long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    d_ff_expert=16384,
    n_experts=8,
    top_k=2,
    vocab_size=32768,
    activation="silu",
    gated_mlp=True,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    microbatches=8,
    fsdp=True,
)

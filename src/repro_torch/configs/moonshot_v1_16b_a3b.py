"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    d_ff_expert=1408,
    n_experts=64,
    top_k=6,
    vocab_size=163840,
    activation="silu",
    gated_mlp=True,
    rope_theta=50_000.0,
    microbatches=4,
    fsdp=True,
)

"""qwen3-14b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    microbatches=8,
    fsdp=True,
)

"""qwen3-0.6b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    microbatches=2,
    fsdp=False,
)

"""qwen2-1.5b [dense] — GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    microbatches=2,
    fsdp=False,
)

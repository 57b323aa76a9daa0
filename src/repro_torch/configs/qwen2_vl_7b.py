"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only per the assignment: the vision frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings merged into the token
stream, plus 3-axis (t,h,w) M-RoPE position ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),   # sums to head_dim//2 = 64
    rope_theta=1_000_000.0,
    frontend="patch_embed",
    microbatches=4,
    fsdp=True,
)

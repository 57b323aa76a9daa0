"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

54 Mamba-2 layers; ONE shared full-attention+MLP block (weights shared)
applied after every 6 mamba layers (9 applications). ssm_state=64.
Hybrid recurrent state -> long_500k runs (attention KV kept for the 9 shared
applications only).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,                   # shared block MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    microbatches=2,
    fsdp=False,
)

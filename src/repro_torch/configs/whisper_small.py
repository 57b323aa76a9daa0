"""whisper-small [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

Backbone only: the log-mel conv frontend is a STUB — ``input_specs()``
provides precomputed frame embeddings [B, enc_len, d_model]. Decode shapes
lower the DECODER step (self-attn KV cache + cross-attn over encoder output).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=12,             # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    gated_mlp=False,
    qkv_bias=True,
    enc_dec=True,
    enc_len=1500,
    rope_theta=0.0,          # whisper uses learned/sinusoidal abs positions
    frontend="audio_frames",
    microbatches=1,
    fsdp=False,
)

"""Optimizer of the port: AdamW, its learning-rate schedule and int8
gradient compression (counterpart of ``repro/optim``)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .compress import compress_residual, int8_decode, int8_encode
from .schedule import cosine_warmup

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_residual", "cosine_warmup", "int8_decode",
           "int8_encode"]

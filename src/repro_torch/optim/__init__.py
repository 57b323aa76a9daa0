"""Optimizer of the port: AdamW and its learning-rate schedule (counterpart
of ``repro/optim``; int8 gradient compression is not ported yet)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_warmup

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_warmup"]

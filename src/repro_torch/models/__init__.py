"""Model functions of the port (decoder-only stacks: qwen3, qwen2, moonshot,
mixtral, xlstm, zamba2)."""
from .model import (decode_step, embed_tokens, forward_hidden, forward_loss,
                    init_cache, init_params, kv_cache_size, lm_logits,
                    n_shared_applications, pattern_stages, prefill)

__all__ = ["decode_step", "embed_tokens", "forward_hidden", "forward_loss",
           "init_cache", "init_params", "kv_cache_size", "lm_logits",
           "n_shared_applications", "pattern_stages", "prefill"]

"""Architecture configuration for the PyTorch port.

The port's own copy of ``repro.configs.base.ArchConfig``: the same fields,
defaults and ``reduced()``, so a config built on one side can be rebuilt on
the other with ``ArchConfig(**dataclasses.asdict(cfg))``. The port reads
only the fields its ported block kinds use; the rest are kept so the two
stay field-for-field equal. The JAX class's parameter-count methods have no
caller in the port and are left out. ``ShapeConfig`` and ``SHAPES`` are
copied too: the sweep's warm cache is keyed by a shape cell.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Block kinds of the JAX package (the port implements all five)
ATTN = "attn"          # full transformer block (attention + MLP)
MOE = "moe"            # transformer block with MoE MLP
MAMBA2 = "mamba2"      # Mamba-2 SSD block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                       # dense | ssm | hybrid | moe | vlm | audio
    source: str = ""                  # provenance tag from the assignment table

    # -- transformer dims --------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0                     # dense MLP intermediate (0 = no MLP)
    vocab_size: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    activation: str = "silu"          # silu | squared_relu | gelu
    gated_mlp: bool = True            # SwiGLU-style vs single up-proj
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (sums to head_dim//2)
    sliding_window: int = 0           # 0 = full attention (mixtral: 4096)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM (Mamba-2) -----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # -- xLSTM -------------------------------------------------------------
    xlstm_slstm_every: int = 0        # every k-th block is sLSTM (0 = none)
    xlstm_qk_dim_factor: float = 0.5  # qk head dim = v head dim * factor

    # -- block pattern / hybrid -------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # empty -> derived from family
    shared_attn_every: int = 0        # zamba2: shared attn block after every k

    # -- encoder/decoder (whisper) ----------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500               # encoder frames for decode-shape specs

    # -- frontend stubs (vlm / audio) -------------------------------------
    frontend: str = "none"            # none | patch_embed | audio_frames

    # -- numerics / training ----------------------------------------------
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # nemotron uses bfloat16 to fit HBM
    remat: str = "full"               # none | dots | full
    microbatches: int = 1             # gradient-accumulation steps
    max_seq: int = 4096

    # -- sharding ----------------------------------------------------------
    fsdp: bool = True                 # shard params/opt-state over data axis too
    seq_parallel: bool = False        # shard residual-stream activations on seq
    attn_impl: str = "chunked"        # chunked | naive | pallas
    # decode with a seq-sharded KV cache: gather the (tiny) q instead of
    # letting GSPMD reshard the (huge) cache (§Perf iteration 2; False =
    # paper-faithful baseline behaviour for A/B measurement)
    decode_gather_q: bool = True
    # GQA decode via grouped einsum — never materializes the head-repeated
    # KV (§Perf iteration 3; False = repeat-expand baseline)
    decode_grouped_attn: bool = True
    # context-parallel attention as an explicit shard_map over 'model'
    # (one dk/dv psum per call instead of one per KV block; False = the
    # GSPMD-auto baseline)
    cp_shard_map: bool = True

    # ----------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern and self.n_layers:
            object.__setattr__(self, "block_pattern", self._derive_pattern())

    def _derive_pattern(self) -> Tuple[str, ...]:
        if self.family == "moe":
            return (MOE,) * self.n_layers
        if self.family == "ssm":          # xLSTM
            pat = []
            for i in range(self.n_layers):
                k = self.xlstm_slstm_every
                pat.append(SLSTM if (k and (i + 1) % k == 0) else MLSTM)
            return tuple(pat)
        if self.family == "hybrid":       # zamba2
            return (MAMBA2,) * self.n_layers
        return (ATTN,) * self.n_layers    # dense / vlm / audio backbones

    # -- derived quantities -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4) if not self.xlstm_slstm_every
                      else min(self.n_layers, self.xlstm_slstm_every),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            d_ff_expert=128 if self.d_ff_expert else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=256,
            capacity_factor=4.0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state or self.family == "ssm" else 64,
            sliding_window=64 if self.sliding_window else 0,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            shared_attn_every=2 if self.shared_attn_every else 0,
            enc_len=32,
            max_seq=128,
            microbatches=1,
            block_pattern=(),     # re-derived for the reduced layer count
            fsdp=False,
            seq_parallel=False,
        )



@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment table."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}

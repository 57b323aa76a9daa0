"""Architecture configuration for the PyTorch port.

The port's own copy of ``repro.configs.base.ArchConfig``: the same fields,
defaults and ``reduced()``, so a config built on one side can be rebuilt on
the other with ``ArchConfig(**dataclasses.asdict(cfg))``. The port reads
only the fields its ported block kinds use; the rest are kept so the two
stay field-for-field equal. The JAX class's skip rule and analytic
parameter counts (``is_subquadratic``, ``param_count``,
``active_param_count``, ``shape_applicable``) are copied for the dry-run
(``launch/dryrun.py``) and the step builder (``launch/steps.py``).
``ShapeConfig`` and ``SHAPES`` are copied too: the sweep's warm cache is
keyed by a shape cell, and the dry-run walks the cells.
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

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (skip rule)."""
        kinds = set(self.block_pattern)
        if kinds & {MAMBA2, MLSTM, SLSTM}:
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        emb = self.vocab_size * d
        n += emb if self.tie_embeddings else 2 * emb
        for kind in self.block_pattern:
            n += d  # ln1
            if kind == ATTN or kind == MOE:
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
                if self.qk_norm:
                    n += 2 * hd
                n += d  # ln2
                if kind == ATTN and self.d_ff:
                    mult = 3 if self.gated_mlp else 2
                    n += mult * d * self.d_ff
                elif kind == MOE:
                    mult = 3 if self.gated_mlp else 2
                    n += self.n_experts * mult * d * self.d_ff_expert
                    n += d * self.n_experts  # router
            elif kind == MAMBA2:
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
                n += d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads)
                n += conv_dim * self.ssm_conv + conv_dim
                n += 2 * nheads + d_in  # A_log, D, internal norm
                n += d_in * d
            elif kind == MLSTM:
                d_in = self.ssm_expand * d
                dqk = int(d_in * self.xlstm_qk_dim_factor)
                n += d * (2 * d_in)                  # up proj (x & z branches)
                n += d_in * (2 * dqk)                # q,k projections
                n += d_in * d_in                     # v projection
                n += 2 * (d_in * self.n_heads + self.n_heads)  # i,f gate proj
                n += d_in                            # internal norm
                n += d_in * d                        # down proj
            elif kind == SLSTM:
                d_in = d
                n += 4 * (d * d_in + d_in * d_in // self.n_heads + d_in)
                from repro_torch.models.xlstm import slstm_ff_dim
                ff = slstm_ff_dim(d)
                n += 3 * d * ff + d
        if self.shared_attn_every:
            # one shared attention+MLP block (zamba2), counted once
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += 3 * d * self.d_ff if self.gated_mlp else 2 * d * self.d_ff
            n += 2 * d
        n += d  # final norm
        if self.enc_dec:
            # encoder blocks (attn + mlp) + cross-attn in decoder counted above?
            per_enc = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                       + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d)
            n += self.n_enc_layers * per_enc
            # cross-attention in each decoder layer
            n += self.n_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                  + self.q_dim * d + d)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.gated_mlp else 2
        dead = (self.n_experts - self.top_k) * mult * d * self.d_ff_expert
        return int(self.param_count() - len([k for k in self.block_pattern
                                             if k == MOE]) * dead)

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


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rule from the assignment: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k context infeasible (see DESIGN.md)"
    return True, ""

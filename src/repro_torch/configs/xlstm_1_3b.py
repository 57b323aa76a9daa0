"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (ratio ~7:1). [arXiv:2405.04517]

d_ff=0 per assignment: mLSTM blocks carry their own up/down projection;
sLSTM blocks are followed by a gated FFN per the xLSTM paper.
Recurrent state -> sub-quadratic -> long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    xlstm_slstm_every=8,          # every 8th block is sLSTM (7:1)
    xlstm_qk_dim_factor=0.5,
    ssm_expand=2,
    microbatches=2,
    # NOT FSDP: gathering FSDP'd weights inside the recurrent time loops
    # costs +4.6 TiB/step wire on this arch, and d_in-/dqk-TP of the
    # mLSTM q/k projections adds ~100-200 GiB of activation psums
    # (EXPERIMENTS.md §Perf). The replicated q/k state fits via bf16
    # optimizer moments + the 128-padded TP'd sLSTM FFN.
    fsdp=False,
    opt_state_dtype="bfloat16",
)

"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
pure functions of the step, a Python number or a tensor."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio`` of
    it at ``total_steps``; an fp32 scalar tensor, as the reference's."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)

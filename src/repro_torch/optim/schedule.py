"""Warm-up then cosine decay of the learning rate (``repro.optim.schedule``),
on the device of ``step`` when it is a tensor: no host sync."""
import math

import torch


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10000,
                    min_ratio=0.1):
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)

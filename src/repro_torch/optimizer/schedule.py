"""LR schedules (warmup + cosine decay) as callables of the step: the port
of the JAX package's ``optimizer/schedule.py``.  The step may be a tensor
(AdamW passes its int32 step); the result is a float32 tensor on its
device, computed in float32 as the reference computes it."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def constant(lr: float):
    def fn(step):
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=device)
    return fn

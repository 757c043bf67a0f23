"""Learning-rate schedules (warmup + cosine/linear decay), the port of
``repro.optim.schedule``: each returns ``lr(step)``, an f32 tensor of the
step (a tensor on any device, or a number), computed as ``repro`` computes it
in f32."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _progress(step: torch.Tensor, warmup_steps: int, total_steps: int) -> torch.Tensor:
    return torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = _progress(step, warmup_steps, total_steps)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = _progress(step, warmup_steps, total_steps)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - t))

    return lr

"""LR schedules (port of ``repro.optim.schedules``). WSD (warmup–stable–decay)
is MiniCPM's schedule [arXiv:2404.06395].

Plain functions of a step (an int or a tensor) returning a 0-d f32 tensor,
in the JAX functions' order of f32 operations.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32)


def wsd(step, peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_ratio: float = 0.1):
    """Warmup-Stable-Decay: linear warmup → constant plateau → exp decay."""
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps - stable_steps) / max(decay_steps, 1)
    ratio = torch.tensor(final_ratio, dtype=F32, device=step.device)
    decay = peak_lr * torch.pow(ratio, torch.clamp(t, 0.0, 1.0))
    plateau = torch.tensor(peak_lr, dtype=F32, device=step.device)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < warmup_steps + stable_steps, plateau, decay))


def cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
           final_ratio: float = 0.1):
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_ratio + (1 - final_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, peak_lr: float):
    return torch.full_like(_step(step), peak_lr)

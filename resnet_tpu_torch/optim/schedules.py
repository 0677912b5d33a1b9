"""Learning-rate schedules: the port of resnet_tpu.optim.schedules.

Each schedule maps the step (an int32 device scalar) to an fp32 device
scalar with the same fp32 arithmetic as the JAX functions, so the step
never leaves the device.
"""

from __future__ import annotations

import math

import torch


def constant(base_lr: float):
    def fn(step):
        return torch.full((), base_lr, dtype=torch.float32, device=step.device)

    return fn


def cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
           final_lr: float = 0.0):
    def fn(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        decay_steps = max(total_steps - warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / decay_steps, 0.0, 1.0)
        cos = final_lr + 0.5 * (base_lr - final_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos).to(torch.float32)

    return fn


def step_decay(base_lr: float, boundaries, factor: float = 0.1, warmup_steps: int = 0):
    """Piecewise-constant decay (the classic /10 at epochs 30/60/80)."""
    bounds = sorted(boundaries)

    def fn(step):
        step = step.to(torch.float32)
        b = torch.tensor(bounds, dtype=torch.float32).to(step.device)
        n_passed = torch.sum(step >= b).to(torch.float32)
        lr = base_lr * torch.pow(torch.full_like(step, factor), n_passed)
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, lr).to(torch.float32)

    return fn


def make_schedule(cfg):
    """A schedule from an OptimizerConfig."""
    if cfg.schedule == "constant":
        return constant(cfg.learning_rate)
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("cosine schedule requires total_steps > 0")
        return cosine(cfg.learning_rate, cfg.total_steps, cfg.warmup_steps)
    if cfg.schedule == "step":
        if cfg.total_steps <= 0:
            raise ValueError("step schedule requires total_steps > 0")
        boundaries = [cfg.total_steps * f for f in (0.3, 0.6, 0.8)]
        return step_decay(cfg.learning_rate, boundaries, 0.1, cfg.warmup_steps)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")

"""Learning-rate schedules (step -> f32 lr), port of ``repro/optim/schedules.py``.

The step is the host-side counter, so the lr is computed on the host in f32
0-d tensors, operation for operation as the JAX package computes it (``cos``
may differ from XLA's by an ulp), and returned as a Python float holding
that f32 value.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def constant_schedule(lr: float):
    def sched(step):
        return float(_f32(lr))

    return sched


def linear_warmup(lr: float, warmup_steps: int):
    def sched(step):
        frac = torch.clamp((_f32(step) + 1) / max(1, warmup_steps), max=1.0)
        return float(lr * frac)

    return sched


def cosine_schedule(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        prog = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(_f32(lr) * warm * cos)

    return sched

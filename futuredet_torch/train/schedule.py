"""One-cycle learning rate and momentum.

Port of `futuredet_tpu/train/schedule.py` (reference `OneCycle`,
`det3d/solver/learning_schedules_fastai.py:70-97`):
  phase 1 (pct_start): cosine anneal lr_max / div -> lr_max, mom0 -> mom1
  phase 2:             cosine anneal lr_max -> lr_max / div / 1e4,
                       mom1 -> mom0
In float32, step by step as the JAX package computes it, so both give the
same values.
"""
from __future__ import annotations

import math

import torch


def annealing_cos(start: float, end: float, pct: torch.Tensor
                  ) -> torch.Tensor:
    cos_out = torch.cos(math.pi * pct) + 1.0
    return end + (start - end) / 2.0 * cos_out


def _phases(step: int, total_steps: int, pct_start: float):
    a1 = int(total_steps * pct_start)
    s = torch.tensor(step, dtype=torch.int32)
    p1 = torch.clamp_min(s / max(a1, 1), 0.0)
    p2 = (s - a1) / max(total_steps - a1, 1)
    return step < a1, p1, p2


def one_cycle_lr(step: int, *, total_steps: int, lr_max: float,
                 div_factor: float, pct_start: float) -> float:
    warm, p1, p2 = _phases(step, total_steps, pct_start)
    low = lr_max / div_factor
    return float(annealing_cos(low, lr_max, p1) if warm
                 else annealing_cos(lr_max, low / 1e4, p2))


def one_cycle_momentum(step: int, *, total_steps: int, moms,
                       pct_start: float) -> float:
    warm, p1, p2 = _phases(step, total_steps, pct_start)
    return float(annealing_cos(moms[0], moms[1], p1) if warm
                 else annealing_cos(moms[1], moms[0], p2))

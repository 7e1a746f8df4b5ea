"""Box geometry the training targets need.

Port of `limit_period` of `futuredet_tpu/core/boxes.py` (reference
`det3d/core/bbox/box_np_ops.py:360-361`); the rest of that module serves
paths the port does not run yet.
"""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = 2 * math.pi) -> torch.Tensor:
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    # a tensor divisor: on the card a Python scalar one becomes a multiply
    # by its reciprocal, which can move a wrap point by an ulp
    p = torch.tensor(period, dtype=val.dtype, device=val.device)
    return val - torch.floor(val / p + offset) * p

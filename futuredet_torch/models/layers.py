"""Shared NN building blocks (NCHW inside, like torch).

Port of `futuredet_tpu/models/layers.py`. Norm semantics match the
reference's `build_norm_layer(dict(type="BN", eps=1e-3, momentum=0.01))`.
The blocks are flat `nn.Sequential`s so that their `state_dict` keys are the
reference det3d keys (`.0` conv, `.1` BN, `.2` ReLU).
"""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; flax momentum 0.99


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, padding: int = None) -> List[nn.Module]:
    """[Conv2d, BatchNorm2d, ReLU]. Padding defaults to the explicit
    symmetric (k-1)//2, which is torch's own: a stride-2 3x3 window starts
    at -1, as the JAX package forces with explicit padding."""
    p = (kernel - 1) // 2 if padding is None else padding
    return [nn.Conv2d(cin, cout, kernel, stride=stride, padding=p, bias=bias),
            nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU()]


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True):
        super().__init__(*conv_bn_relu(cin, cout, kernel, stride, bias))


class DeconvBNReLU(nn.Sequential):
    """k == stride transposed conv (the RPN "deblock"), no bias."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(
            nn.ConvTranspose2d(cin, cout, stride, stride=stride, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU())


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):     # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])             # (out, in, ...) / (out, in)


@torch.no_grad()
def init_weights_(root: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal weights (the flax default: std 1/sqrt(fan_in)) drawn from
    `generator` in module order, zero biases, unit BN. Runs on the CPU so the
    same seed gives the same weights whatever device the model goes to."""
    for m in root.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(_fan_in(m)))
            if m.bias is not None:
                m.bias.zero_()

"""Shared NN building blocks (NCHW inside, like torch).

Port of `futuredet_tpu/models/layers.py`. Norm semantics match the
reference's `build_norm_layer(dict(type="BN", eps=1e-3, momentum=0.01))`,
with flax's running variance in training (`BatchNorm2d`).
The blocks are flat `nn.Sequential`s so that their `state_dict` keys are the
reference det3d keys (`.0` conv, `.1` BN, `.2` ReLU).
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; flax momentum 0.99


class SplitInputConv2d(nn.Conv2d):
    """A Conv2d computed as the sum of convs over groups of at most
    MAX_CIN input channels (the same parameters and keys as Conv2d).

    cuDNN's heuristics (torch 2.11, CUDA 12.8, fp32 without TF32) pick an
    FFT algorithm for the 256 -> 128 3x3 conv at 180x180, the stem of the
    VoxelNet RPN: 167-250 ms and a 16.7 GB workspace on an H100, where the
    same conv as two 128-channel convs takes 0.5 ms
    (scripts/torch_probe_stem.py)."""
    MAX_CIN = 128

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_channels <= self.MAX_CIN or self.groups != 1:
            return super().forward(x)
        out = None
        for c0 in range(0, self.in_channels, self.MAX_CIN):
            y = F.conv2d(x[:, c0:c0 + self.MAX_CIN],
                         self.weight[:, c0:c0 + self.MAX_CIN], None,
                         self.stride, self.padding, self.dilation)
            out = y if out is None else out + y
        return out if self.bias is None else out + self.bias[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (same parameters, buffers and keys) whose
    training step updates `running_var` with the BIASED batch variance, as
    flax's BatchNorm does (`futuredet_tpu/models/layers.py:43-45`); torch's
    own update uses the unbiased one. The batch is normalised with the
    biased variance either way."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, padding: int = None,
                 conv=nn.Conv2d) -> List[nn.Module]:
    """[conv, BatchNorm2d, ReLU]. Padding defaults to the explicit
    symmetric (k-1)//2, which is torch's own: a stride-2 3x3 window starts
    at -1, as the JAX package forces with explicit padding."""
    p = (kernel - 1) // 2 if padding is None else padding
    return [conv(cin, cout, kernel, stride=stride, padding=p, bias=bias),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
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
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
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

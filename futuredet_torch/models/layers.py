"""Shared NN building blocks (NCHW inside, like torch).

Port of `futuredet_tpu/models/layers.py`. Norm semantics match the
reference's `build_norm_layer(dict(type="BN", eps=1e-3, momentum=0.01))`,
with flax's running variance in training (`BatchNorm2d`).
The blocks are flat `nn.Sequential`s so that their `state_dict` keys are the
reference det3d keys (`.0` conv, `.1` BN, `.2` ReLU).

`compute_dtype` is the flax `dtype` of the JAX package's layers (the
config's `compute_dtype="bfloat16"`, its serving mode,
`futuredet_tpu/models/layers.py:26-61`): parameters stay fp32; a conv
casts its input, weight and bias to bf16 and returns bf16; a BatchNorm
computes its statistics and normalises in fp32 and returns bf16, as
`flax.linen.BatchNorm(dtype=bf16)` does. Without it, an input of another
float type is promoted to the parameters' type, as jnp promotes bf16 with
fp32. Training follows flax's dtype at every step of the backward: a
bf16 conv's gradients are bf16 products (dW promoted to the fp32
parameter by the cast's backward), the BatchNorm's fp32 (`BatchNorm2d`).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import pmean, world_size

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; flax momentum 0.99


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's dtype name ("bfloat16" or None) -> torch dtype or None
    (fp32)."""
    if name is None:
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"dtype {name!r}: the port takes 'bfloat16' or None")


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters and keys) in `compute_dtype`, where the
    bias is added to the conv's rounded output, as flax's `nn.Conv` adds
    it."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.to(self.compute_dtype
                                           or self.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None or self.bias is None:
            return self._conv_forward(self.cast(x), self.cast(self.weight),
                                      self.cast(self.bias))
        y = self._conv_forward(self.cast(x), self.cast(self.weight), None)
        return y + self.cast(self.bias)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (same parameters and keys) in `compute_dtype`;
    no output_size argument."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)


class SplitInputConv2d(Conv2d):
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
        x, w = self.cast(x), self.cast(self.weight)
        out = None
        for c0 in range(0, self.in_channels, self.MAX_CIN):
            y = F.conv2d(x[:, c0:c0 + self.MAX_CIN],
                         w[:, c0:c0 + self.MAX_CIN], None,
                         self.stride, self.padding, self.dilation)
            out = y if out is None else out + y
        return (out if self.bias is None
                else out + self.cast(self.bias)[:, None, None])


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (same parameters, buffers and keys) whose
    training step updates `running_var` with the BIASED batch variance, as
    flax's BatchNorm does (`futuredet_tpu/models/layers.py:43-45`); torch's
    own update uses the unbiased one. The batch is normalised with the
    biased variance either way.

    In `compute_dtype`, eval normalises in fp32 with the running
    statistics and casts the output to it. Training under
    `compute_dtype`, and every training step of a data-parallel run,
    takes flax's own formula (`flax.linen.normalization._compute_stats`,
    `_normalize`): E[x] and E[x^2] in fp32 over the batch, averaged over
    the ranks (`parallel/collectives.py::pmean`, differentiable, the JAX
    `axis_name`), var = max(0, E[x^2] - E[x]^2), then (x - mean) *
    (rsqrt(var + eps) * weight) + bias in fp32, whose gradient reaches a
    bf16 x rounded to bf16, as jnp's promotion does."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and (self.compute_dtype is not None
                              or world_size() > 1):
            return self._flax_train(x)
        y = self._normalize(x.to(self.weight.dtype))
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _flax_train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(self.weight.dtype)
        mean, mean2 = pmean(xf.mean((0, 2, 3)),
                            torch.square(xf).mean((0, 2, 3)))
        var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        m, v, w, b = (t[:, None, None]
                      for t in (mean, var, self.weight, self.bias))
        y = (x - m) * (torch.rsqrt(v + self.eps) * w) + b
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
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
                 conv=Conv2d, compute_dtype: Optional[torch.dtype] = None
                 ) -> List[nn.Module]:
    """[conv, BatchNorm2d, ReLU]. Padding defaults to the explicit
    symmetric (k-1)//2, which is torch's own: a stride-2 3x3 window starts
    at -1, as the JAX package forces with explicit padding."""
    p = (kernel - 1) // 2 if padding is None else padding
    return [conv(cin, cout, kernel, stride=stride, padding=p, bias=bias,
                 compute_dtype=compute_dtype),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM,
                        compute_dtype=compute_dtype),
            nn.ReLU()]


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, conv=Conv2d,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(*conv_bn_relu(cin, cout, kernel, stride, bias,
                                       conv=conv,
                                       compute_dtype=compute_dtype))


class DeconvBNReLU(nn.Sequential):
    """k == stride transposed conv (the RPN "deblock"), no bias."""

    def __init__(self, cin: int, cout: int, stride: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(
            ConvTranspose2d(cin, cout, stride, stride=stride, bias=False,
                            compute_dtype=compute_dtype),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM,
                        compute_dtype=compute_dtype),
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

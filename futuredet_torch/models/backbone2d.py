"""RPN — the multi-scale BEV conv neck.

Port of `futuredet_tpu/models/backbone2d.py` (reference
`det3d/models/necks/rpn.py:23-159`): per scale a strided conv block of
`layer_nums[i]`+1 convs, each scale brought back to a common size by a
"deblock" (transpose conv for us_stride > 1, strided k=stride conv for
us_stride < 1), outputs concatenated along channels. Takes and returns NCHW.

Module layout = reference keys: `blocks.{i}` is
[ZeroPad2d(0), conv(1), bn(2), relu(3), conv(4+3j), bn(5+3j), relu(6+3j)...],
`deblocks.{k}` is [conv or transpose conv(0), bn(1), relu(2)].
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import ConvBNReLU, DeconvBNReLU, SplitInputConv2d, conv_bn_relu


class RPN(nn.Module):
    def __init__(self, in_channels: int,
                 layer_nums: Tuple[int, ...] = (5, 5),
                 ds_strides: Tuple[int, ...] = (1, 2),
                 ds_filters: Tuple[int, ...] = (128, 256),
                 us_strides: Tuple[float, ...] = (1, 2),
                 us_filters: Tuple[int, ...] = (256, 256)):
        super().__init__()
        self.upsample_start = len(layer_nums) - len(us_strides)
        blocks, deblocks = [], []
        cin = in_channels
        for i, n in enumerate(layer_nums):
            c = ds_filters[i]
            # explicit pad + unpadded conv: the reference's stem structure
            layers = [nn.ZeroPad2d(1),
                      *conv_bn_relu(cin, c, 3, ds_strides[i], bias=False,
                                    padding=0, conv=SplitInputConv2d)]
            for _ in range(n):
                layers += conv_bn_relu(c, c, 3, 1, bias=False)
            blocks.append(nn.Sequential(*layers))
            k = i - self.upsample_start
            if k >= 0:
                s = us_strides[k]
                if s > 1:
                    deblocks.append(DeconvBNReLU(c, us_filters[k], int(s)))
                else:
                    st = int(round(1 / s))
                    deblocks.append(ConvBNReLU(c, us_filters[k], st, st,
                                               bias=False))
            cin = c
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            k = i - self.upsample_start
            if k >= 0:
                ups.append(self.deblocks[k](x))
        return torch.cat(ups, dim=1) if ups else x

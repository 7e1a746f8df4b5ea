"""RPN — the multi-scale BEV conv neck.

Port of `futuredet_tpu/models/backbone2d.py` (reference
`det3d/models/necks/rpn.py:23-159`): per scale a strided conv block of
`layer_nums[i]`+1 convs, each scale brought back to a common size by a
"deblock" (transpose conv for us_stride > 1, strided k=stride conv for
us_stride < 1), outputs concatenated along channels. Takes and returns NCHW.

Module layout = reference keys: `blocks.{i}` is
[ZeroPad2d(0), conv(1), bn(2), relu(3), conv(4+3j), bn(5+3j), relu(6+3j)...],
`deblocks.{k}` is [conv or transpose conv(0), bn(1), relu(2)].

Under spatial sharding (`models/layers.py`) the RPN runs on a band of
rows. The bands are those of its coarsest level (`parallel/mesh.py::
band_bounds`), times each finer level's stride: every block and deblock
then maps its band onto the next level's, and the deblocks' outputs
concatenate on every rank with no re-banding.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import spanned
from .layers import (BandPad2d, ConvBNReLU, DeconvBNReLU, SplitInputConv2d,
                     Stack, conv_bn_relu)


class RPN(nn.Module):
    def __init__(self, in_channels: int,
                 layer_nums: Tuple[int, ...] = (5, 5),
                 ds_strides: Tuple[int, ...] = (1, 2),
                 ds_filters: Tuple[int, ...] = (128, 256),
                 us_strides: Tuple[float, ...] = (1, 2),
                 us_filters: Tuple[int, ...] = (256, 256),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        cd = dict(compute_dtype=compute_dtype)
        self.upsample_start = len(layer_nums) - len(us_strides)
        blocks, deblocks = [], []
        cin = in_channels
        for i, n in enumerate(layer_nums):
            c = ds_filters[i]
            # explicit pad + unpadded conv: the reference's stem structure
            layers = [BandPad2d(1, 3, ds_strides[i]),
                      *conv_bn_relu(cin, c, 3, ds_strides[i], bias=False,
                                    padding=0, conv=SplitInputConv2d, **cd)]
            layers[1].after_band_pad = True
            for _ in range(n):
                layers += conv_bn_relu(c, c, 3, 1, bias=False, **cd)
            blocks.append(Stack(*layers))
            k = i - self.upsample_start
            if k >= 0:
                s = us_strides[k]
                if s > 1:
                    deblocks.append(DeconvBNReLU(c, us_filters[k], int(s),
                                                 **cd))
                else:
                    st = int(round(1 / s))
                    deblocks.append(ConvBNReLU(c, us_filters[k], st, st,
                                               bias=False, **cd))
            cin = c
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)
        # rows of the input and of the output for one row of the coarsest
        # level
        self.in_rows = math.prod(ds_strides)
        self.out_rows = round(self.in_rows * us_strides[0] / math.prod(
            ds_strides[:self.upsample_start + 1])) if deblocks \
            else 1

    @spanned("neck")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            k = i - self.upsample_start
            if k >= 0:
                ups.append(self.deblocks[k](x))
        x = torch.cat(ups, dim=1) if ups else x
        return x if self.compute_dtype is None else x.float()

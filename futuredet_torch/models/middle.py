"""Sparse 3D middle encoder, the VoxelNet backbone.

Port of `futuredet_tpu/models/middle.py` (`SparseConv`, `SparseBasicBlock`,
`SparseMiddleEncoder`; reference `SpMiddleResNetFHD`,
`det3d/models/backbones/scn.py:84-177`): 4 stages of {stride-2 sparse conv
+ 2 submanifold residual blocks}, 16 -> 32 -> 64 -> 128 channels over the
(41, 1440, 1440) grid, then a scatter of the last stage to a dense
(B, Z, Y, X, C) canvas whose z-stack is folded into channels z-major
(channel z*C + c). Every sparse conv goes through kernel K2
(`ops/sparse_conv.py::subm_conv_apply`). One table per stage serves all its
submanifold convs (spconv's indice_key, `scn.py:20,99`).

Training: every BatchNorm takes its statistics per sample (the sites'
sample index), as the JAX encoder does under `nn.vmap`, and, with
gradients on, each strided conv builds its inverse table, over which K2
computes that conv's input gradient.

Parameters carry the reference keys (`conv_input.{0,1}`,
`conv1.{j}.conv1/bn1/conv2/bn2`, `conv{s+1}.{0,1,3+j}`) and the spconv
weight layout (kd, kh, kw, Cin, Cout), viewed as (27, Cin, Cout) at call
time, so a reference backbone loads as it is.

Only the all-sparse form is ported: the JAX package's masked dense tail
(`dense_from_stage`, `DenseConv3d`, `DenseBasicBlock`) is queued in
ROADMAP.md.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from ..ops.sparse_conv import (SparseGrid, downsample_coords, make_grid,
                               neighbor_table, out_dims_of, scatter_dense,
                               strided_gather_table, strided_inverse_table,
                               subm_conv_apply)
from .readers import MaskedBatchNorm


class SparseConv(nn.Module):
    """One 3x3x3 sparse conv (submanifold or strided: the table decides).
    `weight` is spconv's (3, 3, 3, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform +-(27 * Cin)^-1/2 (the JAX package's `_kernel_init`,
        torch's Conv3d scaling), drawn on the CPU from `generator`; zero
        bias."""
        std = 1.0 / math.sqrt(27 * self.cin)
        u = torch.rand(self.weight.shape, generator=generator)
        self.weight.copy_((2 * u - 1) * std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                inverse_table: torch.Tensor = None) -> torch.Tensor:
        return subm_conv_apply(x, table,
                               self.weight.reshape(27, self.cin, self.cout),
                               self.bias, inverse_table)


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with BN and a residual (ref scn.py:37-80)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SparseConv(features, features)
        self.bn1 = MaskedBatchNorm(features)
        self.conv2 = SparseConv(features, features)
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                grid: SparseGrid, batch_size: int) -> torch.Tensor:
        identity = x
        x = torch.relu(self.bn1(self.conv1(x, table), None, grid.batch,
                                batch_size))
        x = self.bn2(self.conv2(x, table), None, grid.batch, batch_size)
        return torch.relu(x + identity)


def stage_pads(s: int, dims) -> Tuple[int, int, int]:
    """Stage 3 uses z padding 0 (ref conv4 padding [0, 1, 1],
    `scn.py:129`), giving the 41 -> 21 -> 11 -> 5 depth chain; a z-grid
    too shallow for that falls back to padding 1."""
    pads = (0, 1, 1) if s == 3 else (1, 1, 1)
    if out_dims_of(dims, pads)[0] < 1:
        pads = (1, 1, 1)
    return pads


class SparseMiddleEncoder(nn.Module):
    """`site_counts` holds the active sites of stages 0..3 of the last
    forward (over the whole batch)."""

    def __init__(self, num_input_features: int = 5,
                 channels: Tuple[int, ...] = (16, 32, 64, 128),
                 grid_zyx: Tuple[int, int, int] = (41, 1440, 1440)):
        super().__init__()
        self.grid_zyx = tuple(grid_zyx)
        c = channels
        self.conv_input = nn.ModuleList([
            SparseConv(num_input_features, c[0], bias=False),
            MaskedBatchNorm(c[0])])
        self.conv1 = nn.ModuleList([SparseBasicBlock(c[0]) for _ in range(2)])
        for s in range(1, 4):
            self.add_module(f"conv{s + 1}", nn.ModuleList([
                SparseConv(c[s - 1], c[s], bias=False), MaskedBatchNorm(c[s]),
                nn.ReLU(), SparseBasicBlock(c[s]), SparseBasicBlock(c[s])]))
        self.site_counts: List[int] = []

    def forward(self, voxel_feats: torch.Tensor, coords: torch.Tensor,
                batch: torch.Tensor = None, batch_size: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """voxel_feats (N, C), coords (N, 3) zyx of distinct voxels, batch
        (N,) sample index (default 0) -> (dense BEV (B, Y, X, Z*C) with
        channel z*C + c, active z-mask of the reference extra_conv
        (B, Y, X, Dz))."""
        dims = self.grid_zyx
        grid, order = make_grid(coords, dims, batch)
        x = voxel_feats[order]
        table = neighbor_table(grid, dims)
        conv, bn = self.conv_input
        x = torch.relu(bn(conv(x, table), None, grid.batch, batch_size))
        for block in self.conv1:
            x = block(x, table, grid, batch_size)
        counts = [len(grid.ids)]
        for s in range(1, 4):
            down, bn, _relu, *blocks = getattr(self, f"conv{s + 1}")
            pads = stage_pads(s, dims)
            out_dims = out_dims_of(dims, pads)
            ngrid = downsample_coords(grid, out_dims, pads)
            # the strided conv reads the previous stage's sites
            dtable = strided_gather_table(grid, ngrid, dims, pads=pads)
            inv = (strided_inverse_table(grid, ngrid, out_dims, pads=pads)
                   if torch.is_grad_enabled() else None)
            x = torch.relu(bn(down(x, dtable, inv), None, ngrid.batch,
                              batch_size))
            grid, dims = ngrid, out_dims
            table = neighbor_table(grid, dims)
            for block in blocks:
                x = block(x, table, grid, batch_size)
            counts.append(len(grid.ids))
        self.site_counts = counts

        # z-crush input (ref extra_conv :140-146 and .dense() :165-168):
        # the last stage on a dense canvas, z folded into channels
        canvas = scatter_dense(x, grid, dims, batch_size)      # (B,Z,Y,X,C)
        mask = scatter_dense(torch.ones_like(x[:, :1]), grid, dims,
                             batch_size)[..., 0] > 0         # (B, Z, Y, X)
        B, Z, Y, X, C = canvas.shape
        # active sites of the ref extra_conv output ((3,1,1) kernel, stride
        # (2,1,1), no z padding): the detector re-masks z_crush with it
        if Z >= 3:
            zmask = torch.stack([mask[:, 2 * d:2 * d + 3].any(1)
                                 for d in range((Z - 3) // 2 + 1)], -1)
        else:
            zmask = mask.any(1)[..., None]
        return canvas.permute(0, 2, 3, 1, 4).reshape(B, Y, X, Z * C), zmask

"""Pillar feature reader — point-major, sortless.

Port of `futuredet_tpu/models/readers.py` (`MaskedBatchNorm`,
`PillarFeatureNetDirect`): points are decorated with the cluster offset (from
the pillar mean over every in-range point) and the pillar-centre offset,
go through Linear+BN+ReLU, and are max-pooled straight into the full
(B*H*W, C) canvas, so no sort and no pillar budget is needed. The reference
semantics are those of `det3d/models/readers/pillar_encoder.py:59-153`.

Segment sums become `index_add_`; segment maxima become `scatter_reduce_`
"amax" onto a -inf buffer whose untouched rows are then zeroed.
Inference only: training BN (biased batch variance, running-stat updates)
comes with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import BN_EPS, BN_MOMENTUM


class MaskedBatchNorm(nn.Module):
    """BatchNorm over a flat (N, C) point set with a validity mask. The
    parameter and buffer names are BatchNorm1d's, so reference keys
    (`norm.weight`, `norm.running_mean`, ...) load directly."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm training (masked batch statistics with the "
                "biased variance) comes with the training slice")
        del valid  # eval normalises every row with the running statistics
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class PFNLayer(nn.Module):
    def __init__(self, cin: int, units: int):
        super().__init__()
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = MaskedBatchNorm(units)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.linear(x), valid))


def _segment_max(values: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Per-segment max of (N, C) rows; empty segments give 0."""
    out = values.new_full((n_seg, values.shape[1]), float("-inf"))
    out.scatter_reduce_(0, seg[:, None].expand_as(values), values, "amax",
                        include_self=False)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


class PillarFeatureNetDirect(nn.Module):
    """Sortless pillarization + PFN + direct canvas scatter.

    pad_floor_cap: reference-checkpoint parity quirk. The reference's padded
    zero rows pass through BN+ReLU and join the per-pillar max, so every
    pillar with fewer than max_points_per_voxel points sees a "phantom" row
    as an elementwise floor (layer 0: relu(bn(0)); layer i>0: the previous
    phantom concatenated with the pillar max). Set it to the reference's
    max_points_per_voxel to reproduce that; 0 disables it.
    """

    def __init__(self, num_input_features: int = 5,
                 num_filters: Tuple[int, ...] = (64,),
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0,
                                                54.0, 54.0, 3.0),
                 grid_hw: Tuple[int, int] = (512, 512),
                 pad_floor_cap: int = 0):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.grid_hw = tuple(grid_hw)
        self.pad_floor_cap = pad_floor_cap
        layers = []
        cin = num_input_features + 5
        for i, ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            units = ch if last else ch // 2     # ref PFNLayer:29-31
            layers.append(PFNLayer(cin, units))
            cin = 2 * units
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor,
                points_valid: torch.Tensor) -> torch.Tensor:
        """points (B, P, F), points_valid (B, P) -> canvas (B, H, W, C)."""
        B, P, F = points.shape
        H, W = self.grid_hw
        vx, vy = self.voxel_size
        x0, y0 = self.pc_range[0], self.pc_range[1]
        z0, z1 = self.pc_range[2], self.pc_range[5]
        dev = points.device

        pts = points.reshape(B * P, F)
        # divide by a tensor on the points' device: on the card, a Python
        # scalar divisor becomes a multiply by its reciprocal, which can put
        # a point near a pillar boundary into the neighbouring pillar
        vsize = torch.tensor([vx, vy], dtype=pts.dtype, device=dev)
        ix = torch.floor((pts[:, 0] - x0) / vsize[0]).to(torch.int64)
        iy = torch.floor((pts[:, 1] - y0) / vsize[1]).to(torch.int64)
        ok = (points_valid.reshape(-1) & (ix >= 0) & (ix < W)
              & (iy >= 0) & (iy < H) & (pts[:, 2] >= z0) & (pts[:, 2] <= z1))
        batch_idx = torch.arange(B, device=dev).repeat_interleave(P)
        n_seg = B * H * W + 1
        pid = torch.where(ok, (batch_idx * H + iy) * W + ix,
                          torch.full_like(ix, n_seg - 1))

        w = ok.to(pts.dtype)[:, None]
        sums = pts.new_zeros((n_seg, 4)).index_add_(
            0, pid, torch.cat([pts[:, :3] * w, w], -1))
        # one gather serves both the cluster offset and the pad-floor mask
        g = sums[pid]
        cnt_pt = torch.clamp_min(g[:, 3:], 1.0)
        f_cluster = pts[:, :3] - g[:, :3] / cnt_pt

        cx = ix.to(pts.dtype) * vx + (vx / 2 + x0)
        cy = iy.to(pts.dtype) * vy + (vy / 2 + y0)
        f_center = torch.stack([pts[:, 0] - cx, pts[:, 1] - cy], -1)

        x = torch.cat([pts, f_cluster, f_center], -1) * w
        floor = self.pad_floor_cap > 0
        if floor:
            fm_pt = g[:, 3:] < float(self.pad_floor_cap)
            # layer-0 phantom rows are all zeros: one row serves all pillars
            phantom = x.new_zeros((1, x.shape[-1]))
        ok_col = ok[:, None]
        for i, layer in enumerate(self.pfn_layers):
            last = i == len(self.pfn_layers) - 1
            x = layer(x, ok)
            if floor:
                # running BN stats: exact at eval, the parity regime
                ph = layer(phantom, phantom.new_ones(phantom.shape[0],
                                                     dtype=torch.bool))
                ph_pt = ph if ph.shape[0] == 1 else ph[pid]
                # max over points of max(x_p, ph) == max(pooled, ph) for any
                # occupied pillar, so the floor is applied on the points side
                x_eff = torch.where(fm_pt, torch.maximum(x, ph_pt), x)
            else:
                x_eff = x
            pool_in = torch.where(ok_col, x_eff,
                                  x_eff.new_tensor(float("-inf")))
            pooled = _segment_max(pool_in, pid, n_seg)
            if not last:
                x = torch.cat([x, pooled[pid]], -1)
                if floor:
                    # layer i>0 phantoms differ per pillar (they carry the
                    # pillar max)
                    phantom = torch.cat(
                        [ph.expand(n_seg, ph.shape[-1]), pooled], -1)
        return pooled[:B * H * W].reshape(B, H, W, -1)

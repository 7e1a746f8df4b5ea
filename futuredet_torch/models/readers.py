"""Pillar feature reader — point-major, sortless.

Port of `futuredet_tpu/models/readers.py` (`MaskedBatchNorm`,
`PillarFeatureNetDirect`, and the sorted reader `PillarFeatureNet` with
`scatter_to_bev`): points are decorated with the cluster offset (from
the pillar mean over every in-range point) and the pillar-centre offset,
go through Linear+BN+ReLU, and are max-pooled straight into the full
(B*H*W, C) canvas, so no sort and no pillar budget is needed. The reference
semantics are those of `det3d/models/readers/pillar_encoder.py:59-153`.

Segment sums become `index_add_`; segment maxima become `scatter_reduce_`
"amax" onto a -inf buffer whose untouched rows are then zeroed. Its
gradient splits evenly among tied points, as `jax.ops.segment_max`'s does
(ties are common: ReLU zeros, and points at the phantom floor).
`MaskedBatchNorm` also serves the sparse middle encoder.

`PillarFeatureNet` is the sorted, point-major PFN over a
`ops/voxelize.py::PointVoxelMap` (each kept pillar's first `max_points`
points), pooled into one row per kept pillar, and `scatter_to_bev` puts
such rows on the BEV canvas. As in the JAX package, the detector builds
only the direct reader; the sorted one is for callers that voxelize first.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.voxelize import PointVoxelMap
from ..parallel.collectives import pmean, psum
from ..utils.profiling import spanned
from .layers import BN_EPS, BN_MOMENTUM


class MaskedBatchNorm(nn.Module):
    """BatchNorm over a flat (N, C) point or site set with a validity mask.
    The parameter and buffer names are BatchNorm1d's, so reference keys
    (`norm.weight`, `norm.running_mean`, ...) load directly.

    Training (`futuredet_tpu/models/readers.py:48-58`): the masked batch
    mean and biased variance over cnt = max(sum(valid), 1) rows normalise
    x, and the running statistics become 0.99 * old + 0.01 * batch. Given
    `sample` (N,), each row's sample index in [0, num_samples), the
    statistics are those of the JAX middle encoder under
    `nn.vmap(axis_name="batch")` (`futuredet_tpu/models/detector.py:188-198`):
    each sample's mean and its variance around that mean, each averaged
    over the samples (a sample with no row counts with zeros). Without
    `sample` they pool every row, as the pillar reader and dense towers
    do. In a data-parallel run each rank's mean and variance (around its
    own mean) are then averaged over the ranks, differentiably
    (`parallel/collectives.py::pmean`), as the JAX `axis_name` pmean
    does; every rank holds the same number of samples.

    Under a space layout (`space`, `parallel/mesh.py::SpaceGroup`) this
    BatchNorm runs in the prefix before the canvas, whole on every rank of
    a space group, and its reductions go over the data group alone: the
    per-sample statistics are averaged over it as above, and the pooled
    ones are those of the rows of every data index together (sums of
    x, of the count and of (x - mean)^2 over the data group), as XLA
    computes the JAX reader's over the global batch of the GSPMD step."""
    space = None
    banded = False

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

    def forward(self, x: torch.Tensor, valid: torch.Tensor = None,
                sample: torch.Tensor = None,
                num_samples: int = 1) -> torch.Tensor:
        return self.forward_with_running(x, valid, sample, num_samples)[0]

    def forward_with_running(self, x: torch.Tensor,
                             valid: torch.Tensor = None,
                             sample: torch.Tensor = None,
                             num_samples: int = 1):
        """(normalised x, the running (mean, var) after this call). In
        training these are the updated statistics, still differentiable in
        the batch's, as the JAX module's variables are when a later call of
        the same apply reads them (the pillar reader's phantom row)."""
        if self.training:
            # a data-parallel run averages them over the ranks, the JAX
            # pmean over ("batch", "data")
            if self.space is not None and sample is None:
                mean, var = self._pooled_stats(x, valid, self.space.data)
            else:
                mean, var = pmean(*self._batch_stats(x, valid, sample,
                                                     num_samples),
                                  group=None if self.space is None
                                  else self.space.data)
            keep = 1.0 - self.momentum
            run_mean = keep * self.running_mean + self.momentum * mean
            run_var = keep * self.running_var + self.momentum * var
            with torch.no_grad():
                self.running_mean.copy_(run_mean)
                self.running_var.copy_(run_var)
                self.num_batches_tracked.add_(1)
        else:
            # eval normalises every row with the running statistics
            mean, var = run_mean, run_var = (self.running_mean,
                                             self.running_var)
        return self.normalize(x, mean, var), (run_mean, run_var)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @staticmethod
    def _pooled_stats(x, valid, group):
        """The mean and biased variance of the valid rows of every rank of
        `group` together, differentiable."""
        w = (x.new_ones(x.shape[0]) if valid is None
             else valid.to(x.dtype))
        s, n = psum((x * w[:, None]).sum(0), w.sum()[None], group=group)
        cnt = torch.clamp_min(n, 1.0)
        mean = s / cnt
        ss, = psum((torch.square(x - mean) * w[:, None]).sum(0),
                   group=group)
        return mean, ss / cnt

    @staticmethod
    def _batch_stats(x, valid, sample, num_samples):
        w = (x.new_ones(x.shape[0]) if valid is None
             else valid.to(x.dtype))
        if sample is None or num_samples == 1:
            # one sample's statistics are the pooled ones
            cnt = torch.clamp_min(w.sum(), 1.0)
            mean = (x * w[:, None]).sum(0) / cnt
            var = (torch.square(x - mean) * w[:, None]).sum(0) / cnt
            return mean, var
        # (num_samples, N) membership: per-sample sums are one matmul each
        member = (sample[None, :] == torch.arange(
            num_samples, device=x.device)[:, None]).to(x.dtype)
        onehot = member * w
        cnt = torch.clamp_min(onehot.sum(1, keepdim=True), 1.0)
        mean_b = (onehot @ x) / cnt                       # (S, C)
        # each row's sample mean, broadcast by a matmul (exact: one term is
        # 1 * mean, the others 0): the backward of an index, a scatter of N
        # rows onto S, serialises the duplicates on the card (~17 ms a
        # BatchNorm at full width on an NVIDIA H100 80GB HBM3 at 700 W,
        # scripts/torch_profile.py --train)
        centred = x - member.t() @ mean_b
        var_b = (onehot @ torch.square(centred)) / cnt
        return mean_b.mean(0), var_b.mean(0)


class PFNLayer(nn.Module):
    def __init__(self, cin: int, units: int):
        super().__init__()
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = MaskedBatchNorm(units)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                phantom: torch.Tensor = None):
        """(relu(bn(linear(x))) with the statistics of the `valid` rows, the
        same layer applied to the `phantom` rows or None). The phantom rows
        are normalised with the running statistics, in training the ones
        just updated by x, and update nothing: the JAX reader calls its
        BatchNorm on them a second time with train=False
        (`futuredet_tpu/models/readers.py:196-202`)."""
        y, (run_mean, run_var) = self.norm.forward_with_running(
            self.linear(x), valid)
        if phantom is None:
            return torch.relu(y), None
        ph = self.norm.normalize(self.linear(phantom), run_mean, run_var)
        return torch.relu(y), torch.relu(ph)


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

    @spanned("reader")
    def forward(self, points: torch.Tensor,
                points_valid: torch.Tensor) -> torch.Tensor:
        """points (B, P, F), points_valid (B, P) -> canvas (B, H, W, C). In
        training each BatchNorm pools its statistics over every in-range
        point of the batch (the JAX reader is not under `nn.vmap`)."""
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
        # The per-point gathers of pillar rows whose backward runs (pooled,
        # the phantom) send the points outside `ok` to a spread of real rows,
        # not to the dump row: what they read is masked out below, and the
        # gradient they send back is exactly zero. The sorted accumulate
        # behind a gather's backward walks a run of equal indices serially;
        # with all of them on the dump row it took 146 ms of a full-width
        # train step for 147,022 points in the 300,000-point buffer and
        # 270 ms for 21,727, and under 1 ms spread
        # (scripts/torch_time_pillar_step.py, NVIDIA H100 80GB HBM3, 700 W).
        spread = torch.arange(B * P, device=dev) % (n_seg - 1)
        gid = torch.where(ok, pid, spread)

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
            x, ph = layer(x, ok, phantom if floor else None)
            if floor:
                ph_pt = ph if ph.shape[0] == 1 else ph[gid]
                # max over points of max(x_p, ph) == max(pooled, ph) for any
                # occupied pillar, so the floor is applied on the points side
                x_eff = torch.where(fm_pt, torch.maximum(x, ph_pt), x)
            else:
                x_eff = x
            pool_in = torch.where(ok_col, x_eff,
                                  x_eff.new_tensor(float("-inf")))
            pooled = _segment_max(pool_in, pid, n_seg)
            if not last:
                x = torch.cat([x, pooled[gid]], -1)
                if floor:
                    # layer i>0 phantoms differ per pillar (they carry the
                    # pillar max)
                    phantom = torch.cat(
                        [ph.expand(n_seg, ph.shape[-1]), pooled], -1)
        return pooled[:B * H * W].reshape(B, H, W, -1)


class PillarFeatureNet(nn.Module):
    """Point-major PFN over sorted pillars (`futuredet_tpu/models/readers.py
    ::PillarFeatureNet`, ref `pillar_encoder.py:59-153`): the points of a
    `PointVoxelMap` that its pillars keep are decorated with the cluster
    offset (the point minus the mean of its pillar's kept points) and the
    pillar-centre offset, go through Linear + MaskedBatchNorm + ReLU, and
    are max-pooled per pillar (an empty maximum gives 0). A multi-layer
    `num_filters` concatenates each point's features with its pillar's
    maximum before the next layer. In training the BatchNorm pools its
    statistics over every kept point of the map. The state_dict keys are
    `PillarFeatureNetDirect`'s, so `flax_to_state_dict`'s
    `reader.pfn_layers.*` rows serve both."""

    def __init__(self, num_input_features: int = 5,
                 num_filters: Tuple[int, ...] = (64,),
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0,
                                                54.0, 54.0, 3.0)):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        layers = []
        cin = num_input_features + 5
        for i, ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            units = ch if last else ch // 2     # ref PFNLayer:29-31
            layers.append(PFNLayer(cin, units))
            cin = 2 * units
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, m: PointVoxelMap) -> torch.Tensor:
        """m: the map of `ops/voxelize.py::point_voxel_map` -> (N, C), one
        row per kept pillar, in the map's order."""
        pts = m.points
        N = len(m.first)
        dev = pts.device
        # each sorted point's pillar: the last run head at or before it,
        # kept when it lies within that pillar's first num_points points
        pos = torch.arange(len(pts), device=dev)
        run = torch.searchsorted(m.first, pos, right=True) - 1
        runc = run.clamp(0, max(N - 1, 0))
        valid = (run >= 0) & (pos - m.first[runc] < m.num_points[runc]) \
            if N else torch.zeros(len(pts), dtype=torch.bool, device=dev)
        slot = torch.where(valid, run, torch.full_like(run, N))
        w = valid.to(pts.dtype)[:, None]

        sums = pts.new_zeros((N + 1, 3)).index_add_(0, slot, pts[:, :3] * w)
        cnt = torch.clamp_min(m.num_points, 1).to(pts.dtype)
        means = torch.cat([sums[:N] / cnt[:, None], pts.new_zeros((1, 3))])
        f_cluster = pts[:, :3] - means[slot]

        # coords are zyx: x = c[2], y = c[1]
        coords = torch.cat([m.coords, m.coords.new_zeros((1, 3))])[slot]
        vx, vy = self.voxel_size
        cx = coords[:, 2].to(pts.dtype) * vx + (vx / 2 + self.pc_range[0])
        cy = coords[:, 1].to(pts.dtype) * vy + (vy / 2 + self.pc_range[1])
        f_center = torch.stack([pts[:, 0] - cx, pts[:, 1] - cy], -1)

        x = torch.cat([pts, f_cluster, f_center], -1) * w
        for i, layer in enumerate(self.pfn_layers):
            x, _ = layer(x, valid)
            pooled = _segment_max(
                torch.where(valid[:, None], x,
                            x.new_tensor(float("-inf"))), slot, N + 1)
            if i < len(self.pfn_layers) - 1:
                x = torch.cat([x, pooled[slot]], -1)
        return pooled[:N]


def scatter_to_bev(features: torch.Tensor, coords: torch.Tensor,
                   grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Scatter (V, C) pillar/voxel features into an (H, W, C) BEV canvas
    by index y * W + x (ref PointPillarsScatter, pillar_encoder.py:157-209);
    rows whose coords (zyx) hold -1 go to a trash row."""
    H, W = grid_hw
    y, x = coords[:, 1].long(), coords[:, 2].long()
    ok = (y >= 0) & (x >= 0)
    idx = torch.where(ok, y * W + x, torch.full_like(y, H * W))
    canvas = features.new_zeros((H * W + 1, features.shape[-1]))
    canvas[idx] = torch.where(ok[:, None], features,
                              torch.zeros_like(features))
    return canvas[:H * W].reshape(H, W, features.shape[-1])

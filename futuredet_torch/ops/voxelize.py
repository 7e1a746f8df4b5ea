"""Hard voxelization with per-voxel mean features, on the device.

Port of `futuredet_tpu/ops/voxelize.py` (`point_voxel_map`,
`voxelize_mean`, the FCFS `voxelize`, `points_to_voxel_np`; reference
numba kernel `det3d/ops/point_cloud/point_cloud_ops.py:8-62`):

  point -> voxel id (floor division)  ->  stable sort by id
  -> run boundaries  ->  per-voxel sums of the first max_points points

Semantics, as in the JAX package:
  * a point takes part iff it is valid and all 3 coords lie in the grid;
  * each voxel keeps its first `max_points` points in input order (the
    stable sort keeps that order inside a voxel);
  * when more than `max_voxels` voxels are occupied, the `max_voxels`
    LOWEST linear ids are kept, in ascending z-major id order; the sparse
    middle encoder relies on that order;
  * coords are zyx.

The batch is folded into the sort key (sample-major), so one sort serves
a (B, P, F) batch and the voxels of sample b follow those of sample b-1.
The port sizes its outputs per scene (no padding); `voxelize_mean`
pads to `max_voxels` rows only to give the JAX package's fixed shapes.

The per-voxel sum walks rank 0..max_points-1 of each run in order, so it
adds in the same order on the CPU and on the card (the JAX package's
Hillis-Steele scan is a TPU formulation of the same segment sum).
`points_to_voxel_np` is the port's own copy of the numpy oracle.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class VoxelData(NamedTuple):
    """The hard voxelizer's padded buffers (`voxelize`)."""
    voxels: torch.Tensor      # (max_voxels, max_points, F), zero padded
    coords: torch.Tensor      # (max_voxels, 3) int32 zyx, -1 padded
    num_points: torch.Tensor  # (max_voxels,) int32
    num_voxels: torch.Tensor  # () int64


class PointVoxelMap(NamedTuple):
    """Sorted points and the runs of kept voxels, N voxels over the batch."""
    points: torch.Tensor      # (B*P, F) the points sorted by (sample, id)
    first: torch.Tensor       # (N,) int64 sorted position of each run head
    num_points: torch.Tensor  # (N,) int32 kept points (<= max_points)
    coords: torch.Tensor      # (N, 3) int32 zyx
    batch: torch.Tensor       # (N,) int64 sample index
    num_voxels: torch.Tensor  # (B,) int64 kept voxels per sample
    max_points: int           # the cap of num_points


def point_voxel_map(points: torch.Tensor, points_valid: torch.Tensor,
                    pc_range, voxel_size, *, grid_size: Tuple[int, int, int],
                    max_voxels: int, max_points: int) -> PointVoxelMap:
    """points (B, P, F), points_valid (B, P) bool -> the voxels' runs."""
    B, P, F = points.shape
    gx, gy, gz = grid_size
    total = gx * gy * gz
    dev = points.device
    pts = points.reshape(B * P, F)
    # divide by a tensor on the points' device: on the card, a Python
    # scalar divisor becomes a multiply by its reciprocal, which can put a
    # point near a voxel boundary into the neighbouring voxel
    rmin = torch.tensor(pc_range[:3], dtype=pts.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=pts.dtype, device=dev)
    c = torch.floor((pts[:, :3] - rmin) / vs).to(torch.int64)
    gs = torch.tensor(grid_size, dtype=torch.int64, device=dev)
    ok = points_valid.reshape(-1) & ((c >= 0) & (c < gs)).all(-1)
    sample = torch.arange(B, device=dev).repeat_interleave(P)
    key = sample * total + (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0]
    sentinel = B * total
    key = torch.where(ok, key, torch.full_like(key, sentinel))
    skey, order = torch.sort(key, stable=True)

    head = skey < sentinel
    head[1:] &= skey[1:] != skey[:-1]
    # the number of voxels stays on the card (no host sync), so that
    # torch.export traces it as an unbacked size
    first_all = torch.nonzero(head).squeeze(1)                # every voxel
    n_ok = (skey < sentinel).sum().view(1)
    run_len = torch.diff(first_all, append=n_ok)
    vkey = skey[first_all]
    vb = vkey // total
    # the budget is per sample: keep each sample's lowest max_voxels ids
    counts = torch.zeros(B, dtype=torch.int64, device=dev).scatter_add_(
        0, vb, torch.ones_like(vb))
    before = torch.cumsum(counts, 0) - counts
    local = torch.ones_like(vb).cumsum(0) - 1 - before[vb]
    kept = local < max_voxels
    vkey, vb = vkey[kept], vb[kept]
    lin = vkey - vb * total
    coords = torch.stack([lin // (gx * gy), (lin // gx) % gy, lin % gx],
                         -1).to(torch.int32)
    return PointVoxelMap(
        points=pts[order], first=first_all[kept],
        num_points=torch.clamp_max(run_len[kept], max_points).to(torch.int32),
        coords=coords, batch=vb, num_voxels=torch.clamp_max(counts,
                                                            max_voxels),
        max_points=max_points)


def run_means(m: PointVoxelMap) -> torch.Tensor:
    """(N, F) mean of each voxel's kept points (reference
    VoxelFeatureExtractorV3, `det3d/models/readers/voxel_encoder.py:17-24`).
    Rank r of every run is added in turn, so the sum of a voxel runs in
    its points' input order; the ranks run to the map's cap, a voxel with
    fewer points adding exact zeros, so that the loop's length does not
    depend on the data."""
    n_pts = m.points.shape[0]
    num = m.num_points.to(torch.int64)
    acc = m.points.new_zeros((m.first.shape[0], m.points.shape[1]))
    for r in range(m.max_points):
        rows = m.points.index_select(0, torch.clamp_max(m.first + r,
                                                        n_pts - 1))
        acc = acc + torch.where((num > r)[:, None], rows,
                                torch.zeros((), dtype=rows.dtype,
                                            device=rows.device))
    return acc / torch.clamp_min(num, 1).to(acc.dtype)[:, None]


def voxelize_mean(points: torch.Tensor, point_valid: torch.Tensor,
                  pc_range, voxel_size, *, grid_size: Tuple[int, int, int],
                  max_voxels: int, max_points: int):
    """One sample, the JAX package's fixed shapes: points (P, F), valid
    (P,) -> (features (max_voxels, F), coords (max_voxels, 3) int32 zyx
    padded with -1, num_points (max_voxels,) int32, num_voxels () int)."""
    m = point_voxel_map(points[None], point_valid[None], pc_range,
                        voxel_size, grid_size=grid_size,
                        max_voxels=max_voxels, max_points=max_points)
    n = len(m.first)
    feats = points.new_zeros((max_voxels, points.shape[1]))
    feats[:n] = run_means(m)
    coords = torch.full((max_voxels, 3), -1, dtype=torch.int32,
                        device=points.device)
    coords[:n] = m.coords
    num = torch.zeros(max_voxels, dtype=torch.int32, device=points.device)
    num[:n] = m.num_points
    return feats, coords, num, m.num_voxels[0]


def voxelize(points: torch.Tensor, point_valid: torch.Tensor, pc_range,
             voxel_size, *, grid_size: Tuple[int, int, int],
             max_voxels: int, max_points: int) -> VoxelData:
    """One sample, the reference hard voxelizer's (V, K, F) buffers
    (`futuredet_tpu/ops/voxelize.py:144-161`): points (P, F), valid (P,)
    -> each kept voxel's first `max_points` points in input order, in
    ascending z-major id order, zero padded to `max_voxels` x
    `max_points`. `utils/native.py::voxelize_native` gives the same voxels
    in order of their first point, on the host."""
    m = point_voxel_map(points[None], point_valid[None], pc_range,
                        voxel_size, grid_size=grid_size,
                        max_voxels=max_voxels, max_points=max_points)
    n, F = len(m.first), points.shape[1]
    rank = torch.arange(max_points, device=points.device)
    kept = rank[None] < m.num_points[:, None].to(torch.int64)   # (n, K)
    rows = torch.clamp_max(m.first[:, None] + rank[None],
                           max(m.points.shape[0] - 1, 0))
    voxels = points.new_zeros((max_voxels, max_points, F))
    voxels[:n] = torch.where(kept[..., None], m.points[rows], 0.0)
    coords = torch.full((max_voxels, 3), -1, dtype=torch.int32,
                        device=points.device)
    coords[:n] = m.coords
    num = torch.zeros(max_voxels, dtype=torch.int32, device=points.device)
    num[:n] = m.num_points
    return VoxelData(voxels, coords, num, m.num_voxels[0])


# ---------------------------------------------------------------------------
# numpy oracle: loop port of the reference numba kernel (tests only)
# ---------------------------------------------------------------------------

def points_to_voxel_np(points, voxel_size, coors_range, max_points=35,
                       max_voxels=20000):
    """Loop port of _points_to_voxel_reverse_kernel (ref :8-55)."""
    voxel_size = np.asarray(voxel_size, points.dtype)
    coors_range = np.asarray(coors_range, points.dtype)
    grid_size = np.round((coors_range[3:] - coors_range[:3]) / voxel_size
                         ).astype(np.int32)
    shape_zyx = tuple(grid_size[::-1].tolist())
    num_points_per_voxel = np.zeros((max_voxels,), np.int32)
    coor_to_voxelidx = -np.ones(shape_zyx, np.int32)
    voxels = np.zeros((max_voxels, max_points, points.shape[-1]), points.dtype)
    coors = np.zeros((max_voxels, 3), np.int32)
    voxel_num = 0
    for i in range(points.shape[0]):
        coor = np.zeros(3, np.int32)
        failed = False
        for j in range(3):
            c = np.floor((points[i, j] - coors_range[j]) / voxel_size[j])
            if c < 0 or c >= grid_size[j]:
                failed = True
                break
            coor[2 - j] = c
        if failed:
            continue
        voxelidx = coor_to_voxelidx[coor[0], coor[1], coor[2]]
        if voxelidx == -1:
            voxelidx = voxel_num
            if voxel_num >= max_voxels:
                continue
            voxel_num += 1
            coor_to_voxelidx[coor[0], coor[1], coor[2]] = voxelidx
            coors[voxelidx] = coor
        num = num_points_per_voxel[voxelidx]
        if num < max_points:
            voxels[voxelidx, num] = points[i]
            num_points_per_voxel[voxelidx] += 1
    return (voxels[:voxel_num], coors[:voxel_num],
            num_points_per_voxel[:voxel_num])

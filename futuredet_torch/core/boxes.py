"""Box geometry: the torch angle wrap the training targets use, and the
host numpy geometry of the data pipeline.

Port of `futuredet_tpu/core/boxes.py` (reference
`det3d/core/bbox/box_np_ops.py`): `limit_period` (ref :360-361),
`box_area_bev`, `yaw_to_nusc` and `boxes_to_global` on torch tensors;
`rotation_2d`, `center_to_corner_box2d` (ref :207-285),
`box_collision_test` (the GT-AUG collision test of the reference's numba
`det3d/core/sampler/preprocess.py:882-967`), `points_in_rbbox` (ref :641+,
as a frame transform) and `filter_boxes_outside_range` (ref
`prep.filter_gt_box_outside_range`) on numpy arrays, where the JAX module
has `jnp`.

Box convention (nuScenes lidar): [x, y, z, w, l, h, ..., yaw] with the yaw
stored as -nusc_yaw - pi/2 (ref nusc_common.py:531); w extends along the
box-local x of `center_to_corner_box2d(dims=boxes[:, 3:5])`.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = 2 * math.pi) -> torch.Tensor:
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    # a tensor divisor: on the card a Python scalar one becomes a multiply
    # by its reciprocal, which can move a wrap point by an ulp
    p = torch.tensor(period, dtype=val.dtype, device=val.device)
    return val - torch.floor(val / p + offset) * p


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate (N, K, 2) point sets by (N,) angles, right-multiplying by
    [[cos, -sin], [sin, cos]] as box_np_ops.rotation_2d does."""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("nkj,njm->nkm", points, rot)


_CORNERS_NORM_2D = np.array(
    [[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]]) - 0.5  # ref corners_nd


def center_to_corner_box2d(centers, dims, angles) -> np.ndarray:
    """BEV corners (N, 4, 2) of rotated boxes (ref box_np_ops :265-285)."""
    dims = np.asarray(dims)
    corners = dims[:, None, :] * _CORNERS_NORM_2D.astype(dims.dtype)
    corners = rotation_2d(corners, np.asarray(angles))
    return corners + np.asarray(centers)[:, None, :]


def box_collision_test(corners: np.ndarray, qcorners: np.ndarray
                       ) -> np.ndarray:
    """(N, 4, 2) vs (K, 4, 2) BEV corner sets -> (N, K) bool.

    collision = standup-box overlap AND (any edge pair strictly crosses OR
    one box strictly contains ALL of the other's corners). Every comparison
    is strict, as the reference's `>` / `>= 0` branches: touching
    boundaries do not collide.
    """
    corners = np.asarray(corners, np.float64)
    qcorners = np.asarray(qcorners, np.float64)
    N, K = len(corners), len(qcorners)
    if N == 0 or K == 0:
        return np.zeros((N, K), bool)
    sl = [1, 2, 3, 0]

    # standup gate
    blo, bhi = corners.min(1), corners.max(1)            # (N, 2)
    qlo, qhi = qcorners.min(1), qcorners.max(1)          # (K, 2)
    iw = (np.minimum(bhi[:, None, 0], qhi[None, :, 0])
          - np.maximum(blo[:, None, 0], qlo[None, :, 0])) > 0
    ih = (np.minimum(bhi[:, None, 1], qhi[None, :, 1])
          - np.maximum(blo[:, None, 1], qlo[None, :, 1])) > 0
    gate = iw & ih

    # segment crossings: edges (A->B) of boxes vs (C->D) of qboxes
    A = corners[:, None, :, None, :]                     # (N,1,4,1,2)
    B = corners[:, sl][:, None, :, None, :]
    C = qcorners[None, :, None, :, :]                    # (1,K,1,4,2)
    D = qcorners[:, sl][None, :, None, :, :]

    def ccw(p, q, r):   # (r - p) x (q - p) > 0 in the reference's form
        return ((r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0])
                > (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

    acd, bcd = ccw(A, C, D), ccw(B, C, D)
    abc, abd = ccw(A, B, C), ccw(A, B, D)
    seg = ((acd != bcd) & (abc != abd)).any((-1, -2))    # (N, K)

    def contains(c1, c2):
        """(n,4,2) boxes strictly contain ALL corners of (k,4,2) boxes.
        clockwise: vec = -(corner_k - corner_{k+1}); inside needs
        cross < 0 for every edge/corner pair (ref :935-945)."""
        vec = -(c1 - c1[:, sl])                          # (n, 4, 2)
        dx = c1[:, None, :, None, 0] - c2[None, :, None, :, 0]
        dy = c1[:, None, :, None, 1] - c2[None, :, None, :, 1]
        cross = vec[:, None, :, None, 1] * dx - vec[:, None, :, None, 0] * dy
        return (cross < 0).all((-1, -2))                 # (n, k)

    return gate & (seg | contains(corners, qcorners)
                   | contains(qcorners, corners).T)


def points_in_rbbox(points, boxes, z_axis: bool = True) -> np.ndarray:
    """Boolean mask (P, N): point p inside rotated 3D box n. points
    (P, >=3); boxes (N, 7) [x, y, z, w, l, h, yaw], z at the box centre
    (the reference's origin (0.5, 0.5, 0.5) for nuScenes)."""
    points, boxes = np.asarray(points), np.asarray(boxes)
    d = points[:, None, :3] - boxes[None, :, :3]          # (P, N, 3)
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    # inverse rotation: local_x = cos*dx + sin*dy; local_y = -sin*dx + cos*dy
    lx = c[None, :] * d[..., 0] + s[None, :] * d[..., 1]
    ly = -s[None, :] * d[..., 0] + c[None, :] * d[..., 1]
    inside = ((np.abs(lx) <= boxes[None, :, 3] / 2)
              & (np.abs(ly) <= boxes[None, :, 4] / 2))
    if z_axis:
        inside &= np.abs(d[..., 2]) <= boxes[None, :, 5] / 2
    return inside


def filter_boxes_outside_range(boxes, bv_range) -> np.ndarray:
    """Keep mask of boxes with ANY BEV corner inside [xmin, ymin, xmax,
    ymax] (ref prep.filter_gt_box_outside_range, core/sampler/
    preprocess.py:113-127). As the reference, the corners take dims (w, l)
    and the LAST box column as the angle: rrot for 12-column forecast
    boxes, a quirk preserved."""
    boxes = np.asarray(boxes)
    corners = center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                     boxes[:, -1])          # (N, 4, 2)
    inside = ((corners[..., 0] >= bv_range[0])
              & (corners[..., 0] <= bv_range[2])
              & (corners[..., 1] >= bv_range[1])
              & (corners[..., 1] <= bv_range[3]))
    return np.any(inside, axis=1)


def box_area_bev(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (N, >=5) [x, y, (z), w, l, ...] -> (N,) BEV area w * l, with
    [..., 3] = w and [..., 4] = l."""
    return boxes[:, 3] * boxes[:, 4]


# ---------------------------------------------------------------------------
# Coordinate transforms between the decode output and the nuScenes global
# frame, on tensors.
# ---------------------------------------------------------------------------

def yaw_to_nusc(yaw: torch.Tensor) -> torch.Tensor:
    """Invert the stored-yaw convention: stored = -nusc - pi/2 (ref
    nusc_common:531, applied again on the way out at nusc_common.py:172)."""
    return -yaw - math.pi / 2


def boxes_to_global(boxes_xyz: torch.Tensor, yaw: torch.Tensor,
                    vel: torch.Tensor, lidar2global_rot: torch.Tensor,
                    lidar2global_trans: torch.Tensor):
    """Decoded lidar-frame boxes -> the global frame: (xyz (N, 3), yaw
    (N,), vel (N, 2)).

    lidar2global_rot: (3, 3) rotation composed of calibrated_sensor and
    ego_pose (ref: _lidar_nusc_box_to_global, nusc_common.py:192-214);
    the yaw turns by the rotation's heading about z."""
    xyz = boxes_xyz @ lidar2global_rot.T + lidar2global_trans
    head = torch.atan2(lidar2global_rot[1, 0], lidar2global_rot[0, 0])
    vel3 = torch.cat([vel, torch.zeros_like(vel[:, :1])], dim=1)
    vel_g = vel3 @ lidar2global_rot.T
    return xyz, yaw + head, vel_g[:, :2]

"""Decode of the dense forecast head's maps, and the rotated BEV IoU.

Frozen copy of `futuredet_torch/eval/decode.py::decode_single` (one
pseudo-task per head of the dense mode) and of
`futuredet_torch/ops/rotated_iou.py::pairwise_iou_bev`, unchanged but for
the names. The reference does not run NMS itself: it judges the
program's survivors (`benchmark/check.py`) with this IoU.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_DIV_EPS, _CLIP_EPS, _BIG = 1e-12, 1e-5, 1e30


def decode(experiment: Dict, pd: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One head's NHWC maps (batch 1) -> (boxes (HW, 9) [x, y, z, w, l, h,
    vx, vy, rot], scores (HW,))."""
    osf = experiment["assigner"]["out_size_factor"]
    vx, vy = experiment["voxel"]["voxel_size"][:2]
    x0, y0 = experiment["voxel"]["pc_range"][:2]
    hm = torch.sigmoid(pd["hm"][0])
    H, W, _ = hm.shape
    n = H * W
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=hm.device),
                            torch.arange(W, dtype=torch.float32,
                                         device=hm.device), indexing="ij")
    reg = pd["reg"][0].reshape(n, 2)
    xs = (xs.reshape(n, 1) + reg[:, 0:1]) * osf * vx + x0
    ys = (ys.reshape(n, 1) + reg[:, 1:2]) * osf * vy + y0
    rot = torch.atan2(pd["rot"][0, ..., 0:1], pd["rot"][0, ..., 1:2])
    boxes = torch.cat([xs, ys, pd["height"][0].reshape(n, 1),
                       torch.exp(pd["dim"][0]).reshape(n, 3),
                       pd["vel"][0].reshape(n, 2), rot.reshape(n, 1)], -1)
    return boxes, hm.reshape(n, -1).amax(-1)


def candidates(experiment: Dict, pd: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """NMS's candidates of one head: (boxes (HW, 9), scores (HW,)) of
    `decode`, and the top `pre_max_size` scores in order with the cells
    they belong to (stable sort), -inf where a cell scores under the
    `score_threshold` or lies outside `post_center_limit_range`."""
    t = experiment["test"]
    boxes, scores = decode(experiment, pd)
    lim = torch.tensor(t["post_center_limit_range"], device=boxes.device)
    ok = ((scores > t["score_threshold"])
          & (boxes[:, :3] >= lim[:3]).all(-1)
          & (boxes[:, :3] <= lim[3:]).all(-1))
    masked = torch.where(ok, scores, torch.full_like(scores, -math.inf))
    top, order = torch.sort(masked, descending=True, stable=True)
    pre = t["nms"]["pre_max_size"]
    return boxes, scores, top[:pre], order[:pre]


def nms_frame(boxes: torch.Tensor) -> torch.Tensor:
    """Decode boxes (..., 9) -> the NMS frame (..., 5) [x, y, l, w,
    -rot - pi/2] (the port's `ops/nms.py::rotate_nms`)."""
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 4],
                        boxes[..., 3], -boxes[..., 8] - math.pi / 2], -1)


def _slab(p, d, h):
    par = torch.abs(d) < _DIV_EPS
    safe = torch.where(par, torch.full_like(d, _DIV_EPS), d)
    t1, t2 = (-h - p) / safe, (h - p) / safe
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    inside = torch.abs(p) <= h
    big = torch.full_like(lo, _BIG)
    lo = torch.where(par, torch.where(inside, -big, big), lo)
    hi = torch.where(par, torch.where(inside, big, -big), hi)
    return lo, hi


def _edge_sum(px, py, qx, qy, cx, cy, cc, cs, hx, hy):
    rpx = cc * (px - cx) + cs * (py - cy)
    rpy = -cs * (px - cx) + cc * (py - cy)
    rqx = cc * (qx - cx) + cs * (qy - cy)
    rqy = -cs * (qx - cx) + cc * (qy - cy)
    lox, hix = _slab(rpx, rqx - rpx, hx)
    loy, hiy = _slab(rpy, rqy - rpy, hy)
    zero = torch.zeros_like(lox)
    t0 = torch.maximum(torch.maximum(lox, loy), zero)
    t1 = torch.minimum(torch.minimum(hix, hiy), torch.ones_like(hix))
    ok = t1 > t0
    t0, t1 = torch.where(ok, t0, zero), torch.where(ok, t1, zero)
    ex, ey = qx - px, qy - py
    x0, y0, x1, y1 = px + t0 * ex, py + t0 * ey, px + t1 * ex, py + t1 * ey
    return torch.where(ok, x0 * y1 - y0 * x1, zero)


def _corners(x, y, hx, hy, c, s) -> List:
    pts = []
    for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
        lx, ly = hx if sx > 0 else -hx, hy if sy > 0 else -hy
        pts.append((x + c * lx - s * ly, y + s * lx + c * ly))
    return pts


def _frame(boxes):
    x, y, dx, dy, ang = boxes.unbind(-1)
    return x, y, dx * 0.5, dy * 0.5, torch.cos(ang), torch.sin(ang), dx * dy


def _clipped_sum(corners, cx, cy, cc, cs, hx, hy):
    total = 0.0
    for k in range(4):
        (px, py), (qx, qy) = corners[k], corners[(k + 1) % 4]
        total = total + _edge_sum(px, py, qx, qy, cx, cy, cc, cs, hx, hy)
    return total


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5), (..., M, 5) [x, y, dx, dy, angle] -> (..., N, M)."""
    ax, ay, ahx, ahy, ac, as_, aarea = (t.unsqueeze(-1) for t in _frame(a))
    bx, by, bhx, bhy, bc, bs, barea = (t.unsqueeze(-2) for t in _frame(b))
    sa = _clipped_sum(_corners(ax, ay, ahx, ahy, ac, as_), bx, by, bc, bs,
                      bhx - _CLIP_EPS, bhy - _CLIP_EPS)
    sb = _clipped_sum(_corners(bx, by, bhx, bhy, bc, bs), ax, ay, ac, as_,
                      ahx + _CLIP_EPS, ahy + _CLIP_EPS)
    inter = torch.clamp_min(0.5 * (sa + sb), 0.0)
    union = torch.clamp_min(aarea + barea - inter, 1e-8)
    return inter / union

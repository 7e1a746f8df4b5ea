"""Pairwise rotated-rectangle BEV IoU in plain PyTorch.

Port of `futuredet_tpu/ops/rotated_iou.py`: the same sort-free Liang–Barsky
boundary integral. The intersection of two convex polygons is convex, and
its area is 0.5 * ∮ (x dy − y dx), additive over directed boundary pieces in
any order. The boundary of A∩B is the parts of A's edges inside B plus the
parts of B's edges inside A; each edge is clipped against the other
rectangle in that rectangle's frame (two slab constraints), and each
clipped piece p→q adds p×q.

Collinear boundaries are counted once by an asymmetric epsilon: A's edges
clip against B shrunk by `_CLIP_EPS`, B's edges against A grown by it. The
arithmetic (corner formula, operation order, the 1e30 stand-in for infinity)
is that of kernel K1 (`futuredet_tpu/ops/pallas_nms.py::_nms_kernel`), so
that the port's CUDA NMS kernel, which repeats it op for op, and this
version round alike. K1 calls its victim box A and its killer box B; see
`ops/pallas_nms.py`.

Box parametrization: (x, y, dx, dy, angle), extent dx along the heading.
All functions broadcast over leading batch dimensions. The clamps are
`torch.maximum` / `torch.minimum` against constants, whose gradients split
at a tie as `jnp.maximum`'s do: the RoI head's loss differentiates the IoU
(`models/two_stage.py::proposal_targets`).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

_DIV_EPS = 1e-12
_CLIP_EPS = 1e-5
_BIG = 1e30


def _slab(p, d, h):
    """t-interval of {p + t d : |.| <= h}; empty encoded as lo >= hi."""
    par = torch.abs(d) < _DIV_EPS
    safe = torch.where(par, torch.full_like(d, _DIV_EPS), d)
    t1 = (-h - p) / safe
    t2 = (h - p) / safe
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    inside = torch.abs(p) <= h
    big = torch.full_like(lo, _BIG)
    lo = torch.where(par, torch.where(inside, -big, big), lo)
    hi = torch.where(par, torch.where(inside, big, -big), hi)
    return lo, hi


def _edge_sum(px, py, qx, qy, cx, cy, cc, cs, hx, hy):
    """p×q of the edge p->q clipped to the slab |.|<=h of the clip frame
    (cx, cy, cc, cs). All arguments broadcast."""
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
    t0 = torch.where(ok, t0, zero)
    t1 = torch.where(ok, t1, zero)
    ex = qx - px
    ey = qy - py
    x0 = px + t0 * ex
    y0 = py + t0 * ey
    x1 = px + t1 * ex
    y1 = py + t1 * ey
    return torch.where(ok, x0 * y1 - y0 * x1, zero)


def _corners(x, y, hx, hy, c, s) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """CCW world corners as 4 (x, y) pairs."""
    pts = []
    for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
        lx = hx if sx > 0 else -hx
        ly = hy if sy > 0 else -hy
        pts.append((x + c * lx - s * ly, y + s * lx + c * ly))
    return pts


def _frame(boxes):
    x, y, dx, dy, ang = boxes.unbind(-1)
    return x, y, dx * 0.5, dy * 0.5, torch.cos(ang), torch.sin(ang), dx * dy


def _clipped_sum(corners, cx, cy, cc, cs, hx, hy):
    total = 0.0
    for k in range(4):
        px, py = corners[k]
        qx, qy = corners[(k + 1) % 4]
        total = total + _edge_sum(px, py, qx, qy, cx, cy, cc, cs, hx, hy)
    return total


def pairwise_iou_bev(boxes_a: torch.Tensor,
                     boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5), (..., M, 5) -> (..., N, M) IoU (reference
    boxes_iou_bev_kernel semantics)."""
    ax, ay, ahx, ahy, ac, as_, aarea = (t.unsqueeze(-1)
                                        for t in _frame(boxes_a))
    bx, by, bhx, bhy, bc, bs, barea = (t.unsqueeze(-2)
                                       for t in _frame(boxes_b))
    # A edges clipped to B shrunk by eps; B edges clipped to A grown by eps
    sa = _clipped_sum(_corners(ax, ay, ahx, ahy, ac, as_), bx, by, bc, bs,
                      bhx - _CLIP_EPS, bhy - _CLIP_EPS)
    sb = _clipped_sum(_corners(bx, by, bhx, bhy, bc, bs), ax, ay, ac, as_,
                      ahx + _CLIP_EPS, ahy + _CLIP_EPS)
    s = 0.5 * (sa + sb)
    inter = torch.maximum(s, torch.zeros_like(s))
    union = aarea + barea - inter
    union = torch.maximum(union, torch.full_like(union, 1e-8))
    return inter / union

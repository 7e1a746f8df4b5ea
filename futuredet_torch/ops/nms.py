"""Greedy rotated NMS and circle NMS with static-size outputs.

Port of `futuredet_tpu/ops/nms.py`. Boxes come in the decode layout
(N, 7) [x, y, z, w, l, h, rot] and go to the physical pcdet frame
[x, y, l, w, -rot-pi/2] before IoU (reference box_torch_ops.py:256-257).
The rotated suppression is kernel K1 (`ops/pallas_nms.py`); the JAX
package's Jacobi fixpoint is a TPU formulation of the same greedy result
and is not ported.

Top-k is the prefix of a stable descending sort: `jax.lax.top_k` puts the
lower index first on equal scores, and untrained heads give many equal
scores, while `torch.topk` promises no order among them.

The circle NMS is plain PyTorch, as the JAX package's is plain XLA: a
greedy walk over the finite scores, sized per scene on the host. It is
the operator `torch.ops.futuredet.circle_nms` (CPU and CUDA bodies both
that code; a fake implementation gives its (post_max,) int64 selection
and scalar count), so that `torch.export` keeps it as one node of the
program, as it keeps K1.

`rotate_nms_np` and `iou_bev_np` are the port's own copies of the JAX
package's numpy oracle (tests only).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from .pallas_nms import greedy_alive, rotate_nms_alive


def top_k_stable(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` along the last axis, ties broken by lower index."""
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], order[..., :k]


def _compact(alive: torch.Tensor, order: torch.Tensor, post_max: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survivors in score order -> (G, post_max) original indices, -1 pad,
    and (G,) counts."""
    G = alive.shape[0]
    rank = torch.cumsum(alive.to(torch.int64), -1) - 1
    slot = torch.where(alive & (rank < post_max), rank,
                       torch.full_like(rank, post_max))
    sel = torch.full((G, post_max + 1), -1, dtype=torch.int64,
                     device=alive.device)
    sel.scatter_(1, slot, torch.where(alive, order, torch.full_like(order, -1)))
    count = torch.clamp_max(alive.sum(-1), post_max)
    return sel[:, :post_max], count


def rotate_nms(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, *, iou_threshold: float,
               pre_max: int = 1000, post_max: int = 83
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (..., N, 7), scores (..., N), valid (..., N) bool.

    Returns (selected (..., post_max) int64 indices into the original N,
    -1 padded; keep count (...)). All leading problems go to one K1 launch.
    """
    lead = boxes.shape[:-2]
    N = boxes.shape[-2]
    boxes = boxes.reshape(-1, N, 7)
    scores = scores.reshape(-1, N)
    valid = valid.reshape(-1, N)
    pre_max = min(pre_max, N)
    scores = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    top, order = top_k_stable(scores, pre_max)
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    ok = torch.isfinite(top)
    # K1 and its plain version decide in float32: a float64 model's boxes
    # are rounded to it (a no-op for a float32 model)
    nms_boxes = torch.stack([b[..., 0], b[..., 1], b[..., 4], b[..., 3],
                             -b[..., 6] - math.pi / 2], -1).float()
    alive = rotate_nms_alive(nms_boxes, ok, iou_threshold)
    sel, count = _compact(alive, order, post_max)
    return sel.reshape(*lead, post_max), count.reshape(lead)


def _circle_nms(centers: Tensor, scores: Tensor, valid: Tensor,
                min_radius: float, post_max: int) -> Tuple[Tensor, Tensor]:
    """The operator's body, on the CPU and on the card alike."""
    N = centers.shape[0]
    scores = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    top, order = top_k_stable(scores, N)
    ok = torch.isfinite(top)
    # only finite scores can survive, and they sort first
    n = int(ok.sum())
    c = centers[order[:n]]
    d2 = torch.sum((c[:, None, :] - c[None, :, :]) ** 2, -1)
    alive = torch.zeros_like(ok)
    alive[:n] = greedy_alive((d2 <= min_radius)[None], ok[None, :n])[0]
    sel, count = _compact(alive[None], order[None], post_max)
    return sel[0].clone(), count[0].clone()


def _circle_nms_fake(centers: Tensor, scores: Tensor, valid: Tensor,
                     min_radius: float, post_max: int
                     ) -> Tuple[Tensor, Tensor]:
    return (centers.new_empty((post_max,), dtype=torch.int64),
            centers.new_empty((), dtype=torch.int64))


_LIB = torch.library.Library("futuredet", "FRAGMENT")
_LIB.define("circle_nms(Tensor centers, Tensor scores, Tensor valid, "
            "float min_radius, int post_max) -> (Tensor, Tensor)")
_LIB.impl("circle_nms", _circle_nms, "CPU")
_LIB.impl("circle_nms", _circle_nms, "CUDA")
torch.library.register_fake("futuredet::circle_nms", _circle_nms_fake,
                            lib=_LIB)
circle_nms_op = torch.ops.futuredet.circle_nms.default


def circle_nms(centers: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, *, min_radius: float, post_max: int = 83
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre-distance greedy suppression (reference circle_nms_jit.py:5-29):
    j is suppressed when its squared centre distance to a kept box is
    <= min_radius (the reference passes the threshold as a squared
    distance). centers (N, 2), scores (N,), valid (N,) bool -> (selected
    (post_max,) int64 indices into N, -1 padded; keep count ()), through
    `torch.ops.futuredet.circle_nms`. The selection has no gradient."""
    return circle_nms_op(centers.detach(), scores.detach(), valid,
                         float(min_radius), int(post_max))


# ---------------------------------------------------------------------------
# numpy oracle: sequential greedy with Sutherland–Hodgman polygon IoU
# ---------------------------------------------------------------------------

def _corners_np(b):
    x, y, dx, dy, a = b
    c, s = np.cos(a), np.sin(a)
    loc = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]]) / 2
    rot = np.array([[c, -s], [s, c]])
    return loc @ rot.T + np.array([x, y])


def polygon_clip_np(subject, clip):
    """Sutherland–Hodgman; clip must be convex CCW."""
    def inside(p, a, b):
        return ((b[0] - a[0]) * (p[1] - a[1])
                - (b[1] - a[1]) * (p[0] - a[0])) >= -1e-12

    def inter(p1, p2, a, b):
        d1 = np.asarray(p2) - p1
        d2 = np.asarray(b) - a
        den = d1[0] * d2[1] - d1[1] * d2[0]
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / den
        return p1 + t * d1

    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        inp, out = out, []
        if not inp:
            break
        s = inp[-1]
        for p in inp:
            if inside(p, a, b):
                if not inside(s, a, b):
                    out.append(inter(s, p, a, b))
                out.append(p)
            elif inside(s, a, b):
                out.append(inter(s, p, a, b))
            s = p
    return out


def iou_bev_np(ba, bb):
    ca, cb = _corners_np(ba), _corners_np(bb)
    poly = polygon_clip_np(ca, cb)
    if len(poly) < 3:
        inter = 0.0
    else:
        p = np.array(poly)
        q = np.roll(p, -1, 0)
        inter = 0.5 * abs(np.sum(p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]))
    union = ba[2] * ba[3] + bb[2] * bb[3] - inter
    return inter / max(union, 1e-8)


def rotate_nms_np(boxes, scores, iou_threshold, pre_max=1000, post_max=83):
    order = np.argsort(-scores)[:pre_max]
    nb = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 4], boxes[:, 3],
                   -boxes[:, 6] - np.pi / 2], -1)
    keep = []
    alive = np.ones(len(order), bool)
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(order[i])
        for j in range(i + 1, len(order)):
            if alive[j] and iou_bev_np(nb[order[i]],
                                       nb[order[j]]) > iou_threshold:
                alive[j] = False
    return np.array(keep[:post_max])

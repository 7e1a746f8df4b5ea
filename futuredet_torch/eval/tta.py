"""Double-flip test-time augmentation.

The port's copy of `futuredet_tpu/eval/tta.py` (the reference's
DOUBLE_FLIP path: `Voxelization` double-flip variants, preprocess.py:273-319,
merged in CenterHead.predict). Two formulations:

  * `infer_double_flip_map`: the reference's map averaging. Each flip's
    head maps are unflipped to the canonical frame and averaged as
    activated maps (post-sigmoid heatmaps, exp'd dims; regressions
    linearly), then decoded once: four forwards, one NMS (one K1 launch).
  * `infer_double_flip`: a box-level 4-way ensemble. Each flip is decoded
    in its own frame and its boxes are transformed back: four forwards and
    four NMS (four K1 launches), 4x the detection slots, scores / 4.

Everything runs on the device of the points.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from ..config import ExperimentConfig
from .decode import Detections, decode_and_nms

FLIPS = ((False, False), (True, False), (False, True), (True, True))


def _flip_points(points: torch.Tensor, fy: bool, fx: bool) -> torch.Tensor:
    p = points
    if fy or fx:
        p = p.clone()
    if fy:
        p[..., 1] = -p[..., 1]
    if fx:
        p[..., 0] = -p[..., 0]
    return p


def _unflip_boxes(det: Detections, fy: bool, fx: bool) -> Detections:
    """boxes[..., 8] carries the STORED rot r = -physical_yaw - pi/2. A y
    flip maps physical yaw theta -> -theta, i.e. r -> pi - r; an x flip
    maps theta -> pi - theta, i.e. r -> -r."""
    b = det.boxes
    if fy or fx:
        b = b.clone()
    if fy:   # y was negated: mirror y, vy; stored rot -> pi - r
        b[..., 1] = -b[..., 1]
        b[..., 7] = -b[..., 7]
        b[..., 8] = math.pi - b[..., 8]
    if fx:   # x was negated: mirror x, vx; stored rot -> -r
        b[..., 0] = -b[..., 0]
        b[..., 6] = -b[..., 6]
        b[..., 8] = -b[..., 8]
    return det._replace(boxes=b)


def infer_double_flip(cfg: ExperimentConfig, forward: Callable,
                      points: torch.Tensor, points_valid: torch.Tensor
                      ) -> Detections:
    """forward: (points, valid) -> head pred dicts. Returns the fused
    Detections (4x the per-flip slots, flip by flip; duplicates are left
    to linking)."""
    parts = []
    for fy, fx in FLIPS:
        preds = forward(_flip_points(points, fy, fx), points_valid)
        det = _unflip_boxes(decode_and_nms(cfg, preds), fy, fx)
        parts.append(det._replace(scores=det.scores / len(FLIPS)))
    return Detections(*(torch.cat(field, 1) for field in zip(*parts)))


def unflip_pred_maps(pd: Dict[str, torch.Tensor], fy: bool, fx: bool
                     ) -> Dict[str, torch.Tensor]:
    """One head dict's NHWC maps from a flipped input frame back to the
    canonical frame (the feature map `feats` is dropped).

    BEV row h of the flipped frame is canonical row H-1-h with sub-cell
    offset 1-reg_y (and likewise for columns); y components of velocities
    negate. Rot maps hold (sin r, cos r) of the STORED rot r, for which a y
    flip is r -> pi - r (cos negates) and an x flip is r -> -r (sin
    negates).
    """
    dims = [d for d, f in ((1, fy), (2, fx)) if f]
    out = {k: (torch.flip(v, dims) if dims else v.clone())
           for k, v in pd.items() if k != "feats"}
    for flipped, c in ((fy, 1), (fx, 0)):
        if not flipped:
            continue
        if "reg" in out:
            out["reg"][..., c] = -out["reg"][..., c] + 1.0
        for vk in ("vel", "rvel"):
            if vk in out:
                out[vk][..., c::2] = -out[vk][..., c::2]
        for rk in ("rot", "rrot"):
            if rk in out:
                out[rk][..., c] = -out[rk][..., c]
    return out


def infer_double_flip_map(cfg: ExperimentConfig, forward: Callable,
                          points: torch.Tensor, points_valid: torch.Tensor
                          ) -> Detections:
    """Map-average double flip (the reference's formulation): the four
    flips' maps, unflipped, averaged in activated space, decoded and
    suppressed once. It keeps the standard detection count."""
    acc: List[Dict[str, torch.Tensor]] = []
    for fy, fx in FLIPS:
        preds = [unflip_pred_maps(pd, fy, fx)
                 for pd in forward(_flip_points(points, fy, fx),
                                   points_valid)]
        for pd in preds:
            # the reference averages ACTIVATED maps
            pd["hm"] = torch.sigmoid(pd["hm"])
            pd["dim"] = torch.exp(pd["dim"])
        if not acc:
            acc = preds
        else:
            acc = [{k: a[k] + p[k] for k in a} for a, p in zip(acc, preds)]
    avg = []
    for pd in acc:
        pd = {k: v / len(FLIPS) for k, v in pd.items()}
        # invert, so that decode's sigmoid / exp lands on the averages
        p = torch.clamp(pd["hm"], 1e-6, 1.0 - 1e-6)
        pd["hm"] = torch.log(p) - torch.log1p(-p)
        pd["dim"] = torch.log(torch.clamp_min(pd["dim"], 1e-9))
        avg.append(pd)
    return decode_and_nms(cfg, avg)

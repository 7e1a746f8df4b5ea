"""Heatmap -> boxes decode + per-timestep NMS, on the device of the preds.

Port of `futuredet_tpu/eval/decode.py` (reference `CenterHead.predict` +
`post_processing`, center_head.py:541-747):

  1. expand the head outputs into pseudo-tasks (standard / reverse: slice
     the widened vel map or replicate it; dense: one head per timestep
     already; sparse: forward + reverse; classify: max over the 3
     trajectory classes; wide: slice the heatmap channels; multitask: one
     per class group)                                           (:559-607)
  2. decode each dict from the heatmap grid                     (:621-666)
  3. score/range mask + rotated NMS per pseudo-task             (:698-747)
  4. concatenate with label := pseudo-task index (== timestep), or the
     global class id for multitask class groups                (:675-695)

Every pseudo-task yields exactly `post_max` detection slots with a
validity mask. The pseudo-tasks x B rotated-NMS problems go to kernel K1
in one launch.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..ops.nms import circle_nms, rotate_nms
from ..utils.profiling import span, spanned


class Detections(NamedTuple):
    """Fixed-shape detection set per sample.

    boxes: (B, N, 9) [x, y, z, w, l, h, vx, vy, rot]
    scores/labels/valid: (B, N); label == pseudo-timestep (0..T-1) for
    forecast modes, or the global class id for multitask class groups
    (len(tasks) > 1, classic CenterPoint)
    """
    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


def expand_pseudo_tasks(cfg: ExperimentConfig,
                        preds: List[Dict[str, torch.Tensor]]):
    """The reference's per-mode expansion into pseudo-task dicts (ref
    :557-607)."""
    h = cfg.model.head
    if h.multitask:
        # multitask class groups: one pseudo-task per SepHead; labels
        # become global class ids in decode_and_nms
        return list(preds)
    if h.standard or h.reverse:
        pd = preds[0]
        vels = [pd["vel"][..., 2 * i:2 * i + 2] for i in range(h.timesteps)]
        if h.timesteps == 1:
            vels = h.target_timesteps * vels
        return [{**pd, "vel": v} for v in vels]
    if h.sparse:
        return [{**pd, "vel": pd["vel"][..., 2 * i:2 * i + 2]}
                for pd in preds[:2] for i in range(h.timesteps)]
    if h.classify:
        return [{**pd, "hm": pd["hm"].amax(-1, keepdim=True)} for pd in preds]
    if h.wide_head:
        pd = preds[0]
        return [{**pd, "hm": pd["hm"][..., i:i + 1]}
                for i in range(h.timesteps)]
    return list(preds)          # dense: one head per timestep already


def decode_single(pd: Dict[str, torch.Tensor], cfg: ExperimentConfig):
    """One pseudo-task dict (NHWC maps) -> (B, HW, 9) boxes + (B, HW, C)
    post-sigmoid heatmap."""
    osf = cfg.assigner.out_size_factor
    vx, vy = cfg.voxel.voxel_size[:2]
    x0, y0 = cfg.voxel.pc_range[:2]

    hm = torch.sigmoid(pd["hm"])
    B, H, W, C = hm.shape
    dim = torch.exp(pd["dim"]).reshape(B, H * W, 3)
    rot = torch.atan2(pd["rot"][..., 0:1],
                      pd["rot"][..., 1:2]).reshape(B, H * W, 1)
    reg = pd["reg"].reshape(B, H * W, 2)
    hei = pd["height"].reshape(B, H * W, 1)
    vel = pd["vel"].reshape(B, H * W, 2)

    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=hm.device),
        torch.arange(W, dtype=torch.float32, device=hm.device),
        indexing="ij")
    xs = (xs.reshape(1, H * W, 1) + reg[..., 0:1]) * osf * vx + x0
    ys = (ys.reshape(1, H * W, 1) + reg[..., 1:2]) * osf * vy + y0

    boxes = torch.cat([xs, ys, hei, dim, vel, rot], dim=-1)
    return boxes, hm.reshape(B, H * W, C)


@spanned("decode")
def decode_and_nms(cfg: ExperimentConfig,
                   preds: List[Dict[str, torch.Tensor]]) -> Detections:
    """Full predict path. Returns Detections with N = T * post_max (T
    pseudo-tasks) and labels == pseudo-timestep index (reference label
    offsetting :686-690), or global class ids for multitask."""
    pseudo = expand_pseudo_tasks(cfg, preds)
    tc = cfg.test
    h = cfg.model.head
    T = len(pseudo)
    post = tc.nms.post_max_size

    decs = [decode_single(pd, cfg) for pd in pseudo]
    cmax = max(d[1].shape[-1] for d in decs)
    boxes = torch.stack([d[0] for d in decs])            # (T, B, HW, 9)
    # zero pad (of the narrower multitask groups) after the sigmoid (> 0):
    # it never wins max or argmax
    hm = torch.stack([d[1] if d[1].shape[-1] == cmax
                      else F.pad(d[1], (0, cmax - d[1].shape[-1]))
                      for d in decs])                    # (T, B, HW, Cmax)
    scores = hm.amax(-1)                                 # (T, B, HW)
    _, B, HW, _ = boxes.shape
    if h.multitask:
        # global class id: the task's channel offset + the cell's argmax
        # (offsets added as Python ints: a tensor of them made on the host
        # would be a synchronous copy to the card)
        offs = [sum(len(t) for t in h.tasks[:i]) for i in range(T)]
        labels = torch.stack([hm[i].argmax(-1) + offs[i] for i in range(T)])
    else:
        labels = torch.arange(T, device=boxes.device)[:, None, None].expand(
            T, B, HW)
    rng = torch.tensor(tc.post_center_limit_range, device=boxes.device)
    in_range = ((boxes[..., :3] >= rng[:3]).all(-1)
                & (boxes[..., :3] <= rng[3:]).all(-1))
    ok = (scores > tc.score_threshold) & in_range

    G = T * B
    boxes, scores = boxes.reshape(G, HW, 9), scores.reshape(G, HW)
    labels, ok = labels.reshape(G, HW), ok.reshape(G, HW)
    with span("decode.nms"):
        if tc.circular_nms:
            # per-pseudo-task radius; a short tuple broadcasts (ref
            # :725-728)
            sel = torch.stack([
                circle_nms(boxes[g, :, :2], scores[g], ok[g],
                           min_radius=float(tc.min_radius[
                               min(g // B, len(tc.min_radius) - 1)]),
                           post_max=post)[0]
                for g in range(G)])
        else:
            sel, _ = rotate_nms(boxes[..., [0, 1, 2, 3, 4, 5, 8]], scores,
                                ok, iou_threshold=tc.nms.iou_threshold,
                                pre_max=tc.nms.pre_max_size, post_max=post)
    keep = sel >= 0
    idx = sel.clamp_min(0)
    bb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 9))
    ss = torch.where(keep, torch.gather(scores, 1, idx),
                     torch.zeros((), device=scores.device))
    ll = torch.gather(labels, 1, idx)

    def flat(x):  # (T*B, post, ...) -> (B, T*post, ...)
        x = x.reshape(T, B, *x.shape[1:]).movedim(0, 1)
        return x.reshape(B, T * post, *x.shape[3:])

    return Detections(boxes=flat(bb), scores=flat(ss), labels=flat(ll),
                      valid=flat(keep))

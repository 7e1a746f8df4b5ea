"""CenterNet target assignment, on the device.

Port of `futuredet_tpu/data/targets.py:32-205` (reference AssignLabel,
`det3d/datasets/pipelines/preprocess.py:336-910`): per object a radius,
a gaussian on the heatmap (`core/gaussian.py`) and its anno_box, ind, mask
and cat rows, for all timesteps and a whole batch at once.

Target families (ref :568, :733, :897):
  standard    per-timestep boxes, class = object class           (C = K)
  trajectory  class = static / linear / nonlinear                (C = 3)
  forecast    every timestep's boxes in every map, class = t + 1 (C = T)
  multitask   class groups of classic CenterPoint: the leading axis is
              the task, t = 0's boxes, class = the index within the task
              (C = the widest group, zero-padded)

GT in: gt_boxes (B, T, M, 12) [x, y, z, w, l, h, vx, vy, rvx, rvy, rot,
rrot], gt_classes (B, T, M) 1-based, gt_valid (B, T, M) bool, traj_classes
(B, M). Out: hm (B, T, H, W, C), anno_box (B, T, M, 14), ind / cat
(B, T, M) int64, mask (B, T, M) bool.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..core.boxes import limit_period
from ..core.gaussian import radius_with_mult, render_heatmap


def _assign(cfg: ExperimentConfig, boxes, classes, valid, num_classes,
            class_blocked=False) -> Dict[str, torch.Tensor]:
    """One family: boxes (B, T, M', 12), classes and valid (B, T, M')."""
    W, H = cfg.feature_map_size
    a = cfg.assigner
    dev = boxes.device

    def const(v):
        # tensor divisors: on the card a Python scalar one becomes a
        # multiply by its reciprocal, which can move a centre across a cell
        return torch.tensor(v, dtype=boxes.dtype, device=dev)

    vx_, vy_ = const(cfg.voxel.voxel_size[0]), const(cfg.voxel.voxel_size[1])
    osf = const(a.out_size_factor)
    x, y, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    w, l, h = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    vx, vy = boxes[..., 6], boxes[..., 7]
    rot = limit_period(boxes[..., 10])
    rrot = limit_period(boxes[..., 11])

    w_f = w / vx_ / osf
    l_f = l / vy_ / osf
    size_ok = (w_f > 0) & (l_f > 0)
    T = boxes.shape[1]
    t = torch.arange(T, device=dev)[None, :, None]
    radius = radius_with_mult(
        w_f, l_f, torch.sqrt(vx ** 2 + vy ** 2), t,
        gaussian_overlap=a.gaussian_overlap, min_radius=a.min_radius,
        radius_mult=a.radius_mult)

    coor_x = (x - cfg.voxel.pc_range[0]) / vx_ / osf
    coor_y = (y - cfg.voxel.pc_range[1]) / vy_ / osf
    cx = coor_x.to(torch.int32)       # truncation, as the reference's astype
    cy = coor_y.to(torch.int32)
    ok = (valid & size_ok & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H))
    cls0 = torch.clamp(classes.to(torch.int64) - 1, 0, num_classes - 1)

    hm = render_heatmap(torch.stack([cx, cy], -1), radius, ok, cls0,
                        num_classes, W, H, class_blocked=class_blocked)
    anno = torch.stack([
        coor_x - cx, coor_y - cy, z,
        torch.log(torch.clamp_min(w, 1e-6)),
        torch.log(torch.clamp_min(l, 1e-6)),
        torch.log(torch.clamp_min(h, 1e-6)),
        vx, vy, boxes[..., 8], boxes[..., 9],
        torch.sin(rot), torch.cos(rot), torch.sin(rrot), torch.cos(rrot)], -1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ind = torch.where(ok, cy.to(torch.int64) * W + cx, zero)
    return {"hm": hm.permute(0, 1, 3, 4, 2),
            "anno_box": torch.where(ok[..., None], anno,
                                    torch.zeros_like(anno)),
            "ind": ind, "mask": ok, "cat": torch.where(ok, cls0, zero)}


def _assign_multitask(cfg: ExperimentConfig, boxes, classes, valid
                      ) -> Dict[str, torch.Tensor]:
    """Multitask family (`futuredet_tpu/data/targets.py::
    _assign_multitask_targets`): per class group the t = 0 objects of its
    classes, stacked over tasks on the leading axis, heatmaps zero-padded
    to the widest group."""
    tasks = cfg.model.head.tasks
    names = list(cfg.data.class_names)
    cmax = max(len(t) for t in tasks)
    cls0 = classes[:, :1].to(torch.int64).clamp(0, len(names))
    fams = []
    for task in tasks:
        # global 1-based class id -> within-task 1-based id (0: not ours),
        # by comparisons on the device (a lookup table made on the host
        # would be a synchronous copy to the card)
        tcls = torch.zeros_like(cls0)
        for j, n in enumerate(task):
            ours = cls0 == names.index(n) + 1
            tcls = tcls + ours.to(cls0.dtype) * (j + 1)
        out = _assign(cfg, boxes[:, :1], tcls, valid[:, :1] & (tcls > 0),
                      len(task))
        out["hm"] = F.pad(out["hm"], (0, cmax - len(task)))
        fams.append(out)
    return {k: torch.cat([f[k] for f in fams], 1) for k in fams[0]}


def build_targets_batch(cfg: ExperimentConfig, raw: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """raw: {"gt_boxes" (B, T, M, 12), "gt_classes" (B, T, M), "gt_valid"
    (B, T, M), "traj_classes" (B, M)} on the device -> the target dict of
    `futuredet_tpu/data/targets.py::build_targets_batch`: the standard
    family (the multitask family for class groups), the trajectory and
    forecast families (suffixed keys) under a trajectory sampler, and the
    t = 0 gt_boxes / gt_valid."""
    h = cfg.model.head
    boxes, valid = raw["gt_boxes"], raw["gt_valid"]
    if h.multitask:
        if h.timesteps != 1:
            raise ValueError("multi-task class groups take timesteps == 1")
        out = _assign_multitask(cfg, boxes, raw["gt_classes"], valid)
    else:
        out = _assign(cfg, boxes, raw["gt_classes"], valid,
                      max(1, len(cfg.data.class_names)))
    if cfg.assigner.sampler_type != "standard" \
            and raw.get("traj_classes") is not None:
        cls = raw["traj_classes"][:, None, :].expand_as(valid)
        out.update({f"{k}_trajectory": v for k, v in
                    _assign(cfg, boxes, cls, valid, 3).items()})
        B, T, M, D = boxes.shape
        flat_cls = torch.arange(1, T + 1, device=boxes.device
                                ).repeat_interleave(M)
        fc = _assign(cfg, boxes.reshape(B, 1, T * M, D).expand(B, T, -1, -1),
                     flat_cls.expand(B, T, -1),
                     valid.reshape(B, 1, T * M).expand(B, T, -1), T,
                     class_blocked=True)
        out.update({f"{k}_forecast": v for k, v in fc.items()})
    out["gt_boxes"] = boxes[:, 0]
    out["gt_valid"] = valid[:, 0]
    return out


def build_targets(cfg: ExperimentConfig, gt_boxes, gt_classes, gt_valid,
                  traj_classes=None) -> Dict[str, torch.Tensor]:
    """One sample ((T, M, 12) boxes, ...) -> its target dict, as
    `futuredet_tpu/data/targets.py::build_targets` gives it."""
    raw = {"gt_boxes": gt_boxes[None], "gt_classes": gt_classes[None],
           "gt_valid": gt_valid[None],
           "traj_classes": None if traj_classes is None
           else traj_classes[None]}
    out = build_targets_batch(cfg, raw)
    del out["gt_boxes"], out["gt_valid"]
    return {k: v[0] for k, v in out.items()}

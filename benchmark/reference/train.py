"""The training step of the dense forecast head, in plain PyTorch, fp32.

Frozen copy of the parts of `futuredet_torch/data/targets.py`,
`core/gaussian.py`, `models/losses.py`, `train/schedule.py` and
`train/step.py` that a B = 1 step of the benchmark's configurations runs:
the standard target family (the one the dense head's loss reads), the
focal and L1 losses, the global-norm clip and AdamW under the one-cycle
schedule. Changed from the port: only that family is built, and AdamW is
`torch.optim.AdamW` without foreach.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

_NEG = -1e30
_EPS32 = float(torch.finfo(torch.float32).eps)
# anno_box columns without rvel / rrot heads: [reg, z, dim, vel, sin rr,
# cos rr] (the port's `_TARGET_COLS_10`, a reference quirk kept)
_COLS_10 = (0, 1, 2, 3, 4, 5, 6, 7, 12, 13)
ADAM_B2, ADAM_EPS = 0.999, 1e-8


def _limit_period(val):
    p = torch.tensor(2 * math.pi, dtype=val.dtype, device=val.device)
    return val - torch.floor(val / p + 0.5) * p


def _gaussian_radius(height, width, min_overlap):
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * c1, 0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 ** 2 - 16 * c2, 0.0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def _heatmap(cx, cy, radii, valid, W, H):
    """(T, H, W) max over objects of the CenterNet gaussians, in the log
    domain, exp last, values under fp32 eps set to 0."""
    sigma = (2 * radii + 1).to(torch.float32) / 6.0
    inv = 1.0 / (2.0 * sigma * sigma)

    def axis(c, n):
        d = torch.arange(n, dtype=torch.int32, device=c.device) - c[..., None]
        lg = -(d.to(torch.float32) ** 2) * inv[..., None]
        ok = (d.abs() <= radii[..., None]) & valid[..., None]
        return torch.where(ok, lg, torch.full_like(lg, _NEG))

    ly, lx = axis(cy, H), axis(cx, W)
    g = torch.exp(torch.amax(ly[..., :, None] + lx[..., None, :], dim=-3))
    return torch.where(g < _EPS32, torch.zeros_like(g), g)


def targets(e: Dict, gt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One sample's GT (T, M, 12) -> hm (T, H, W), anno_box (T, M, 14),
    ind and mask (T, M): the standard family of one class."""
    v, a = e["voxel"], e["assigner"]
    pc, vs = v["pc_range"], v["voxel_size"]
    W = round((pc[3] - pc[0]) / vs[0]) // a["out_size_factor"]
    H = round((pc[4] - pc[1]) / vs[1]) // a["out_size_factor"]
    boxes, valid = gt["gt_boxes"], gt["gt_valid"]
    dev = boxes.device

    def const(x):
        return torch.tensor(x, dtype=boxes.dtype, device=dev)

    osf = const(a["out_size_factor"])
    x, y, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    w, l, h = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    vx, vy = boxes[..., 6], boxes[..., 7]
    rot, rrot = _limit_period(boxes[..., 10]), _limit_period(boxes[..., 11])
    w_f, l_f = w / const(vs[0]) / osf, l / const(vs[1]) / osf
    T = boxes.shape[0]
    t = torch.arange(T, device=dev)[:, None]
    base = _gaussian_radius(l_f, w_f, a["gaussian_overlap"])
    mult = (torch.clamp(torch.sqrt(vx ** 2 + vy ** 2) * (1.0 + t) / 2.0,
                        1.0, 4.0) if a["radius_mult"] else 1.0)
    radius = torch.clamp_min(torch.floor(mult * base).to(torch.int32),
                             a["min_radius"])
    coor_x = (x - pc[0]) / const(vs[0]) / osf
    coor_y = (y - pc[1]) / const(vs[1]) / osf
    cx, cy = coor_x.to(torch.int32), coor_y.to(torch.int32)
    ok = (valid & (w_f > 0) & (l_f > 0) & (cx >= 0) & (cx < W) & (cy >= 0)
          & (cy < H))
    anno = torch.stack([
        coor_x - cx, coor_y - cy, z, torch.log(torch.clamp_min(w, 1e-6)),
        torch.log(torch.clamp_min(l, 1e-6)),
        torch.log(torch.clamp_min(h, 1e-6)), vx, vy, boxes[..., 8],
        boxes[..., 9], torch.sin(rot), torch.cos(rot), torch.sin(rrot),
        torch.cos(rrot)], -1)
    return {"hm": _heatmap(cx, cy, radius, ok, W, H),
            "anno_box": torch.where(ok[..., None], anno, 0.0),
            "ind": torch.where(ok, cy.to(torch.int64) * W + cx, 0),
            "mask": ok}


def _gather(fmap, ind):
    """fmap (H, W, C), ind (M,) -> (M, C)."""
    return fmap.reshape(-1, fmap.shape[-1])[ind]


def head_loss(e: Dict, preds: List[Dict[str, torch.Tensor]],
              tg: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sum over the T heads of focal(hm) + weight * sum(code_weights *
    L1(boxes)) (the port's `center_head_loss`, dense mode, batch 1)."""
    h = e["model"]["head"]
    cw = torch.tensor(h["code_weights"], device=tg["hm"].device)
    cols = torch.tensor(_COLS_10, device=cw.device)
    total = 0.0
    for t, pd in enumerate(preds):
        out = torch.clamp(torch.sigmoid(pd["hm"][0]), 1e-4, 1 - 1e-4)
        mask, ind = tg["mask"][t], tg["ind"][t]
        maskf = mask.to(out.dtype)
        gt = torch.square(torch.square(1.0 - tg["hm"][t]))[..., None]
        neg = torch.sum(torch.log(1.0 - out) * torch.square(out) * gt)
        pos_pred = _gather(out, ind)[:, 0]
        num_pos = maskf.sum()
        pos = torch.sum(torch.log(pos_pred) * torch.square(1.0 - pos_pred)
                        * maskf)
        hm_loss = torch.where(num_pos == 0, -neg,
                              -(pos + neg) / torch.clamp_min(num_pos, 1.0))
        box = torch.cat([pd["reg"][0], pd["height"][0], pd["dim"][0],
                         pd["vel"][0], pd["rot"][0]], -1)
        pred = _gather(box, ind)
        target = tg["anno_box"][t].index_select(-1, cols)
        m = maskf[:, None]
        l1 = torch.abs(pred * m - target * m) / (m.sum() + 1e-4)
        total = total + hm_loss + h["weight"] * torch.sum(l1.sum(0) * cw)
    return total


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def one_cycle(o: Dict, step: int, total: int):
    """(lr, b1) at `step` updates done (float32, as the port computes)."""
    a1 = int(total * o["pct_start"])
    s = torch.tensor(step, dtype=torch.int32)
    p1 = torch.clamp_min(s / max(a1, 1), 0.0)
    p2 = (s - a1) / max(total - a1, 1)
    low = o["lr_max"] / o["div_factor"]
    m0, m1 = o["moms"]
    if step < a1:
        return (float(_annealing_cos(low, o["lr_max"], p1)),
                float(_annealing_cos(m0, m1, p1)))
    return (float(_annealing_cos(o["lr_max"], low / 1e4, p2)),
            float(_annealing_cos(m1, m0, p2)))


def make_optimizer(e: Dict, model: nn.Module) -> torch.optim.AdamW:
    o = e["train"]["optim"]
    return torch.optim.AdamW(list(model.parameters()),
                             lr=o["lr_max"] / o["div_factor"],
                             betas=(o["moms"][0], ADAM_B2), eps=ADAM_EPS,
                             weight_decay=o["weight_decay"], foreach=False)


def step(e: Dict, model: nn.Module, opt: torch.optim.AdamW, batch: Dict,
         count: int, total_steps: int) -> Dict[str, torch.Tensor]:
    """One update of `model` (train mode) on a batch of one sample:
    targets, forward, loss, backward, the global-norm clip and AdamW at
    update `count`. Returns the loss and the gradients' global norm."""
    model.zero_grad(set_to_none=True)
    tg = targets(e, {k: v[0] for k, v in batch["targets_raw"].items()})
    loss = head_loss(e, model(batch["points"], batch["points_valid"]), tg)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = e["train"]["optim"]["grad_clip_norm"]
    if float(norm) >= clip:
        for g in grads:
            g.div_(norm).mul_(clip)
    lr, b1 = one_cycle(e["train"]["optim"], count, total_steps)
    for group in opt.param_groups:
        group["lr"], group["betas"] = lr, (b1, ADAM_B2)
    opt.step()
    return {"loss": loss.detach(), "grad_norm": norm.detach()}

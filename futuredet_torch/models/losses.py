"""CenterNet losses and the per-mode loss assembly.

Port of `futuredet_tpu/models/losses.py` (reference
`det3d/models/losses/centernet_loss.py:7-95` and CenterHead.loss,
`center_head.py:396-539`) for every head mode, the first stage of a
two-stage model included.

Layouts: predictions NHWC (B, H, W, C); targets as
`data/targets.py::build_targets_batch` gives them (hm (B, T, H, W, C),
ind / mask / cat (B, T, M), anno_box (B, T, M, 14)).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import HeadConfig

# anno_box columns when the model has vel + rot heads but no rvel / rrot
# (ref center_head.py:462,469): [reg, z, dim, vel, sin rr, cos rr]
_TARGET_COLS_10 = (0, 1, 2, 3, 4, 5, 6, 7, 12, 13)


def _gather_feat(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """fmap (B, H, W, C), ind (B, M) flat y * W + x -> (B, M, C)."""
    B, H, W, C = fmap.shape
    flat = fmap.reshape(B, H * W, C)
    return torch.gather(flat, 1, ind[..., None].expand(-1, -1, C))


def fast_focal_loss(out, target, ind, mask, cat) -> torch.Tensor:
    """CornerNet penalty-reduced focal loss over sigmoid-clipped
    probabilities `out` (ref centernet_loss.py:75-95)."""
    maskf = mask.to(out.dtype)
    # (1 - t)^4 as squares of squares, the JAX package's integer power
    gt = torch.square(torch.square(1.0 - target))
    neg = torch.sum(torch.log(1.0 - out) * torch.square(out) * gt)
    pos_pred = _gather_feat(out, ind)                               # (B,M,C)
    pos_pred = torch.gather(pos_pred, 2, cat[..., None])[..., 0]
    num_pos = torch.sum(maskf)
    pos = torch.sum(torch.log(pos_pred) * torch.square(1.0 - pos_pred)
                    * maskf)
    return torch.where(num_pos == 0, -neg,
                       -(pos + neg) / torch.clamp_min(num_pos, 1.0))


def reg_loss(output, mask, ind, target) -> torch.Tensor:
    """Masked per-dim L1 (ref centernet_loss.py:18-25) -> (D,)."""
    pred = _gather_feat(output, ind)                                # (B,M,D)
    m = mask.to(output.dtype)[..., None]
    loss = torch.abs(pred * m - target * m) / (torch.sum(m) + 1e-4)
    return torch.sum(loss, dim=(0, 1))


def _sigmoid_clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)


def assemble_anno_box(pd: Dict[str, torch.Tensor], cfg: HeadConfig,
                      timestep: Optional[int] = None) -> torch.Tensor:
    """The regression maps in the anno_box layout (ref :447-475): [reg,
    height, dim, vel, (rvel, rot, rrot) or rot]. Standard, reverse and
    sparse heads widen vel (and rvel) by `timesteps`: `timestep` picks its
    2 channels; dense, classify and wide heads pass None."""
    sliced = timestep is not None and not (cfg.dense or cfg.classify
                                           or cfg.wide_head)

    def pick(x):
        return x[..., 2 * timestep:2 * timestep + 2] if sliced else x

    parts = [pd["reg"], pd["height"], pd["dim"], pick(pd["vel"])]
    if "rvel" in dict(cfg.common_heads):
        parts += [pick(pd["rvel"]), pd["rot"], pd["rrot"]]
    else:
        parts += [pd["rot"]]
    return torch.cat(parts, -1)


def center_head_loss(cfg: HeadConfig, preds: List[Dict[str, torch.Tensor]],
                     targets: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """{"loss": (), "hm_loss": (tasks,), "loc_loss": (tasks,)}: per task
    the focal loss of its heatmap and the weighted L1 of its boxes against
    the targets its mode reads, loss = sum hm_loss + weight * loc_loss
    (`futuredet_tpu/models/losses.py::center_head_loss`, ref
    center_head.py:396-539). Future timesteps of a standard, reverse or
    sparse head take `code_weights_forecast`. The first stage of a
    two-stage model (`two_stage`) weighs every timestep by
    `code_weights_two_stage` (vel and rot only, ref :509-511) and has no
    heatmap loss (ref :405-406): its hm_loss is 0."""
    dev = targets["hm"].device
    # one copy to the device for both weight vectors
    cw, cwf = torch.tensor(
        2 * [cfg.code_weights_two_stage] if cfg.two_stage
        else [cfg.code_weights, cfg.code_weights_forecast],
        dtype=torch.float32, device=dev)
    has_rvel = "rvel" in dict(cfg.common_heads)
    cols = torch.tensor(tuple(range(14)) if has_rvel else _TARGET_COLS_10,
                        device=dev)
    T = cfg.timesteps

    def family(suffix, t):
        """(hm, ind, mask, cat, anno_box) of one family at timestep t."""
        return tuple(targets[k + suffix][:, t]
                     for k in ("hm", "ind", "mask", "cat", "anno_box"))

    def loc(pd, i, mask, ind, anno):
        bl = reg_loss(assemble_anno_box(pd, cfg, i), mask, ind,
                      anno.index_select(-1, cols))
        return torch.sum(bl * (cwf if i else cw))

    total = 0.0
    hm_losses, loc_losses = [], []
    for task_id, pd in enumerate(preds):
        hm_pred = _sigmoid_clip(pd["hm"])
        if cfg.dense or cfg.classify:
            suffix = "_trajectory" if cfg.classify else ""
            hm, ind, mask, cat, anno = family(suffix, task_id)
            hm_loss = fast_focal_loss(hm_pred, hm, ind, mask, cat)
            lo = loc(pd, None, mask, ind, anno)
        elif cfg.wide_head:
            # quirk kept (ref :418, :441, :497): the heatmap against the
            # forecast family, the boxes against the trajectory family.
            # The forecast family's object axis is T * M; its first M slots
            # are the t = 0 objects in the trajectory family's order
            hm, ind, mask, cat, _ = family("_forecast", 0)
            hm_loss = fast_focal_loss(hm_pred, hm, ind, mask, cat)
            anno = targets["anno_box_trajectory"][:, 0]
            M = anno.shape[1]
            lo = loc(pd, None, mask[:, :M], ind[:, :M], anno)
        elif cfg.sparse:
            # task 0: the forward chain anchored at t = 0; task 1: the
            # reverse chain at t = T - 1 (ref :411, :427-432, :487). Quirk
            # kept: both take the box target of t = 0 (task 1 indexes its
            # reversed list at T - 1, ref :432, :487), with the anchor's
            # mask and ind
            hm, ind, mask, cat, _ = family("", (T - 1) * task_id)
            hm_loss = fast_focal_loss(hm_pred, hm, ind, mask, cat)
            anno0 = targets["anno_box"][:, 0]
            lo = sum(loc(pd, i, mask, ind, anno0) for i in range(T))
        elif cfg.reverse:
            hm, ind, mask, cat, _ = family("", -1)
            hm_loss = fast_focal_loss(hm_pred, hm, ind, mask, cat)
            lo = sum(loc(pd, i, mask, ind, targets["anno_box"][:, T - 1 - i])
                     for i in range(T))
        else:
            # standard (ref :421, :444, :500, :513-514). Multitask class
            # groups: the leading target axis is the task (timesteps == 1),
            # the heatmap channel-padded to the widest group
            fam = task_id if cfg.multitask else 0
            hm, ind, mask, cat, _ = family("", fam)
            hm_loss = fast_focal_loss(hm_pred, hm[..., :hm_pred.shape[-1]],
                                      ind, mask, cat)
            lo = sum(loc(pd, i, mask, ind, targets["anno_box"][:, fam + i])
                     for i in range(T))
        if cfg.two_stage:
            hm_loss = torch.zeros((), device=dev)
        total = total + hm_loss + cfg.weight * lo
        hm_losses.append(hm_loss)
        loc_losses.append(lo)
    return {"loss": total, "hm_loss": torch.stack(hm_losses),
            "loc_loss": torch.stack(loc_losses)}

"""CenterNet losses and the dense-mode loss assembly.

Port of `futuredet_tpu/models/losses.py:42-122` (reference
`det3d/models/losses/centernet_loss.py:7-95` and CenterHead.loss,
`center_head.py:396-539`) for the dense forecast head; the other head
modes raise.

Layouts: predictions NHWC (B, H, W, C); targets as
`data/targets.py::build_targets_batch` gives them (hm (B, T, H, W, C),
ind / mask / cat (B, T, M), anno_box (B, T, M, 14)).
"""
from __future__ import annotations

from typing import Dict, List

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


def assemble_anno_box(pd: Dict[str, torch.Tensor], cfg: HeadConfig
                      ) -> torch.Tensor:
    """The regression maps in the anno_box layout (ref :447-475), dense
    mode: [reg, height, dim, vel, (rvel, rot, rrot) or rot]."""
    parts = [pd["reg"], pd["height"], pd["dim"], pd["vel"]]
    if "rvel" in dict(cfg.common_heads):
        parts += [pd["rvel"], pd["rot"], pd["rrot"]]
    else:
        parts += [pd["rot"]]
    return torch.cat(parts, -1)


def center_head_loss(cfg: HeadConfig, preds: List[Dict[str, torch.Tensor]],
                     targets: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """{"loss": (), "hm_loss": (T,), "loc_loss": (T,)} of the dense head:
    task t against timestep t's targets, loss = sum_t hm_loss + weight *
    loc_loss (ref center_head.py:396-539)."""
    if not cfg.dense or cfg.two_stage:
        raise NotImplementedError(
            "only the dense head's loss is ported yet (ROADMAP.md, queue 1, "
            "item 5: other head modes)")
    dev = targets["hm"].device
    cw = torch.tensor(cfg.code_weights, dtype=torch.float32, device=dev)
    has_rvel = "rvel" in dict(cfg.common_heads)
    cols = torch.tensor(tuple(range(14)) if has_rvel else _TARGET_COLS_10,
                        device=dev)
    hm_t, ind_t = targets["hm"], targets["ind"]
    mask_t, cat_t, anno_t = targets["mask"], targets["cat"], \
        targets["anno_box"]
    total = 0.0
    hm_losses, loc_losses = [], []
    for t, pd in enumerate(preds):
        hm_loss = fast_focal_loss(_sigmoid_clip(pd["hm"]), hm_t[:, t],
                                  ind_t[:, t], mask_t[:, t], cat_t[:, t])
        tgt = anno_t[:, t].index_select(-1, cols)
        bl = reg_loss(assemble_anno_box(pd, cfg), mask_t[:, t], ind_t[:, t],
                      tgt)
        loc = torch.sum(bl * cw)
        total = total + hm_loss + cfg.weight * loc
        hm_losses.append(hm_loss)
        loc_losses.append(loc)
    return {"loss": total, "hm_loss": torch.stack(hm_losses),
            "loc_loss": torch.stack(loc_losses)}

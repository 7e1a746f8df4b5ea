"""Two-stage refinement: BEV feature pooling at box points + RoI head.

Port of `futuredet_tpu/models/two_stage.py` (reference
`det3d/models/detectors/two_stage.py:9-193`,
`det3d/models/second_stage/bird_eye_view.py:10-41` and
`det3d/models/roi_heads/`): the first stage's BEV map is bilinearly sampled
at 5 points a proposal (centre + 4 side midpoints), and a shared MLP
refines the score and the box.

The first stage's proposals are decoded and NMS'd (kernel K1) inside the
forward, in training too. As in the JAX package, the RoI head reads the
proposals' boxes and, in training, the BEV map detached (`stop_gradient`):
the RoI head's outputs carry no gradient into the first stage. The
returned proposals keep theirs: the train step's `two_stage_loss` takes
its targets from them (JAX step.py:127-130), so the soft IoU targets and
the residual targets pass gradient to the first stage's box maps, as
they do in the JAX step. Training freezes everything but the vel / rot
branches and the RoI head (`two_stage_trainable_mask`, ref
apis/train.py:353-356); the optimizer of `train/step.py::make_optimizer`
takes only that subset.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn

from ..config import ExperimentConfig
from ..ops.deform import bilinear_sample

ROI_HIDDEN = 256
# branches whose parameters train in stage two (the JAX mask's "vel_",
# "rot_", "/vel", "/rot" substrings over the flax paths; rvel and rrot
# contain them)
TRAINABLE_BRANCHES = ("vel", "rot", "rvel", "rrot")


def box_sample_points(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) decoded boxes -> (..., 5, 2) xy sample points: centre + 4
    side midpoints in the box frame (ref bird_eye_view.py pooling
    locations)."""
    x, y = boxes[..., 0], boxes[..., 1]
    w, l = boxes[..., 3], boxes[..., 4]
    yaw = -boxes[..., 8] - math.pi / 2          # stored -> physical heading
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(x)
    offs = torch.stack([z, z, l / 2, z, -l / 2, z, z, w / 2, z, -w / 2],
                       -1).reshape(*x.shape, 5, 2)
    ox = offs[..., 0] * c[..., None] - offs[..., 1] * s[..., None]
    oy = offs[..., 0] * s[..., None] + offs[..., 1] * c[..., None]
    return torch.stack([x[..., None] + ox, y[..., None] + oy], -1)


def pool_bev_features(bev: torch.Tensor, boxes: torch.Tensor,
                      cfg: ExperimentConfig) -> torch.Tensor:
    """bev (H, W, C) of one sample; boxes (N, 9) -> (N, 5 * C), point-major.
    Taps off the map read zero."""
    pts = box_sample_points(boxes)                       # (N, 5, 2)
    vx, vy = cfg.voxel.voxel_size[:2]
    osf = cfg.assigner.out_size_factor
    xs = (pts[..., 0] - cfg.voxel.pc_range[0]) / (vx * osf) - 0.5
    ys = (pts[..., 1] - cfg.voxel.pc_range[1]) / (vy * osf) - 0.5
    feats = bilinear_sample(bev, ys, xs)                 # (N, 5, C)
    return feats.reshape(feats.shape[0], -1)


def pool_batch(bev: torch.Tensor, boxes: torch.Tensor,
               cfg: ExperimentConfig) -> torch.Tensor:
    """bev (B, H, W, C), boxes (B, N, 9) -> (B, N, 5 * C)."""
    return torch.stack([pool_bev_features(m, b, cfg)
                        for m, b in zip(bev, boxes)])


class RoIHead(nn.Module):
    """Shared MLP: pooled features -> (IoU score logit, 7 box residuals)
    (ref roi_heads/roi_head.py: FC stacks for cls + reg). The Linears carry
    the flax Dense names."""

    def __init__(self, in_features: int, hidden: int = ROI_HIDDEN):
        super().__init__()
        self.shared_fc0 = nn.Linear(in_features, hidden)
        self.shared_fc1 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, 1)
        self.reg = nn.Linear(hidden, 7)

    def forward(self, pooled: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.shared_fc1(torch.relu(self.shared_fc0(pooled))))
        return self.cls(x)[..., 0], self.reg(x)


def bev_channels(cfg: ExperimentConfig) -> int:
    """Channels of the neck output the RoI head pools."""
    return sum(cfg.model.rpn.us_filters)


def _refine(boxes: torch.Tensor, resid: torch.Tensor,
            dims_scale: torch.Tensor) -> torch.Tensor:
    """xyz += r[:3], dims *= dims_scale, yaw += r[6]."""
    return torch.cat([boxes[..., :3] + resid[..., :3],
                      boxes[..., 3:6] * dims_scale, boxes[..., 6:8],
                      boxes[..., 8:9] + resid[..., 6:7]], -1)


class TwoStageRefiner(nn.Module):
    """The RoI head applied to decoded first-stage detections (the JAX
    package's public `TwoStageRefiner`; its dims take exp(r) unclipped)."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.cfg = cfg
        self.roi_head = RoIHead(5 * bev_channels(cfg))

    def forward(self, bev: torch.Tensor, boxes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """bev (B, H, W, C); boxes (B, N, 9) -> refined boxes, scores."""
        score, resid = self.roi_head(pool_batch(bev, boxes, self.cfg))
        return (_refine(boxes, resid, torch.exp(resid[..., 3:6])),
                torch.sigmoid(score))


class TwoStageDetector(nn.Module):
    """First stage forward -> decode + NMS proposals -> BEV pooling at 5
    detached box points -> RoI refinement (ref detectors/two_stage.py:
    9-193). `forward` returns (first-stage preds, proposals: Detections,
    roi dict of logits, resid, boxes, scores); the final score is
    sqrt(sigmoid(logit) * stage-1 score), 0 on an invalid proposal (ref
    post_process :139).

    Under a space layout the first stage is banded and returns its maps
    and neck output gathered whole, so that every rank of the space group
    runs the rest whole, as the JAX GSPMD step computes it with its
    outputs replicated: the decode (one K1 launch a forward on every
    rank), the pooling and the RoI head."""

    space = None        # the layout of `models/detector.py::lay_out_space_`

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        from .detector import build_single_stage
        self.cfg = cfg
        self.first_stage = build_single_stage(cfg)
        self.roi_head = RoIHead(5 * bev_channels(cfg))

    @property
    def num_voxels(self) -> List[int]:
        """The VoxelNet first stage's voxels per sample of the last
        forward (AttributeError for pillars, as on the single stage)."""
        return self.first_stage.num_voxels

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                bev_map: Optional[torch.Tensor] = None):
        from ..eval.decode import decode_and_nms

        preds, bev = self.first_stage(points, points_valid, bev_map,
                                      return_bev=True)
        det = decode_and_nms(self.cfg, preds)
        # proposals feed the RoI head but carry no gradient back into the
        # first stage from it; in training the pooled map is detached too
        boxes = det.boxes.detach()
        pooled = pool_batch(bev.detach() if self.training else bev, boxes,
                            self.cfg)
        logits, resid = self.roi_head(pooled)
        refined = _refine(boxes, resid,
                          torch.exp(torch.clamp(resid[..., 3:6], -4.0, 4.0)))
        score = torch.sqrt(torch.clamp_min(
            torch.sigmoid(logits) * det.scores, 1e-12))
        roi = {"logits": logits, "resid": resid, "boxes": refined,
               "scores": torch.where(det.valid, score,
                                     torch.zeros_like(score))}
        return preds, det, roi


def refined_detections(det, roi):
    """The final Detections from the RoI outputs: refined boxes, fused
    scores, the first stage's labels and validity (ref post_process
    :120-155)."""
    from ..eval.decode import Detections
    return Detections(boxes=roi["boxes"], scores=roi["scores"],
                      labels=det.labels, valid=det.valid)


def proposal_targets(proposals: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, *, fg_iou: float = 0.55,
                     bg_iou: float = 0.25):
    """IoU-based proposal targets (ref roi_heads/target_assigner/
    proposal_target_layer.py): each proposal's classification target is its
    clipped-scaled IoU with the best GT (soft-IoU labels), and foreground
    proposals get box residual targets.

    proposals (..., N, 9) decoded layout; gt_boxes (..., M, 12) info
    layout; gt_valid (..., M). Returns (cls_target (..., N), reg_target
    (..., N, 7), fg_mask (..., N))."""
    from ..ops.rotated_iou import pairwise_iou_bev

    def bev5(b, yaw_col):
        return torch.stack([b[..., 0], b[..., 1], b[..., 4], b[..., 3],
                            -b[..., yaw_col] - math.pi / 2], -1)

    iou = pairwise_iou_bev(bev5(proposals, 8), bev5(gt_boxes, 10))
    iou = torch.where(gt_valid[..., None, :], iou, torch.zeros_like(iou))
    best = torch.argmax(iou, dim=-1)            # the first of tied maxima
    best_iou = torch.amax(iou, dim=-1)

    # jnp.clip and jnp.maximum as torch.minimum / torch.maximum: their
    # gradients split at a tie, where torch.clamp's do not
    def at_least(x, lo):
        return torch.maximum(x, torch.full_like(x, lo))

    # soft classification target: 0 below bg, 1 above fg, linear between
    cls_t = torch.minimum(at_least((best_iou - bg_iou) / (fg_iou - bg_iou),
                                   0.0), torch.ones_like(best_iou))
    fg = best_iou >= fg_iou

    g = torch.gather(gt_boxes, -2, best[..., None].expand(
        *best.shape, gt_boxes.shape[-1]))

    def log_ratio(i, j):
        return torch.log(at_least(g[..., i], 1e-3)
                         / at_least(proposals[..., j], 1e-3))

    reg_t = torch.stack([
        g[..., 0] - proposals[..., 0], g[..., 1] - proposals[..., 1],
        g[..., 2] - proposals[..., 2], log_ratio(3, 3), log_ratio(4, 4),
        log_ratio(5, 5), g[..., 10] - proposals[..., 8]], -1)
    return cls_t, reg_t, fg


def two_stage_loss(score_logits: torch.Tensor, resid: torch.Tensor,
                   proposals: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, prop_valid: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """RoI head loss over (B, N) proposals: BCE against the soft-IoU
    targets over the valid proposals, plus the smooth-L1 of the residuals
    over the valid foreground ones (ref roi_heads/roi_head.py). The targets
    are differentiable in the proposals, as in the JAX step."""
    cls_t, reg_t, fg = proposal_targets(proposals, gt_boxes, gt_valid)
    x = score_logits
    w = prop_valid.to(x.dtype)
    # term for term the JAX formula's gradients too: jnp.maximum's at a tie
    # is 1/2, as torch.maximum's; jnp.abs's at 0 is 1, torch.abs's 0
    abs_x = torch.where(x >= 0, x, -x)
    bce = (torch.maximum(x, torch.zeros_like(x)) - x * cls_t
           + torch.log1p(torch.exp(-abs_x)))
    cls_loss = torch.sum(w * bce) / torch.clamp_min(torch.sum(w), 1.0)
    fgw = (fg & prop_valid).to(resid.dtype)[..., None]
    d = resid - reg_t
    sl1 = torch.where(torch.abs(d) < 1.0, 0.5 * d * d, torch.abs(d) - 0.5)
    reg_loss = torch.sum(sl1 * fgw) / torch.clamp_min(torch.sum(fgw), 1.0)
    return {"roi_cls_loss": cls_loss, "roi_reg_loss": reg_loss,
            "loss": cls_loss + reg_loss}


def adopt_first_stage(two_stage_sd: Dict[str, torch.Tensor],
                      first_stage_sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Graft a single-stage state dict under the two-stage model's
    `first_stage.` keys (ref TwoStageDetector.__init__ builds the first
    stage from its own checkpointed config, two_stage.py:21). A strict=False
    merge, as the reference's load_state_dict: keys present in the
    single-stage dict overwrite (their shapes must agree); keys only the
    two-stage model has (the `two_stage_*` convs, the RoI head) keep their
    values."""
    assert any(k.startswith("first_stage.") for k in two_stage_sd), \
        sorted(two_stage_sd)[:5]
    out = dict(two_stage_sd)
    for k, v in two_stage_sd.items():
        src = first_stage_sd.get(k.removeprefix("first_stage."))
        if k.startswith("first_stage.") and src is not None:
            assert v.shape == src.shape, (k, tuple(v.shape), tuple(src.shape))
            out[k] = src
    return out


def two_stage_trainable_mask(model: nn.Module) -> Set[str]:
    """Names of the parameters that train in stage two: the vel / rot
    (rvel / rrot) branches and the RoI head (ref apis/train.py:353-356).
    Everything else is frozen, the shared `two_stage_*` convs included, as
    the JAX package's mask has it (their flax paths hold none of its
    substrings)."""
    return {n for n, _ in model.named_parameters()
            if n.startswith("roi_head.")
            or any(part in TRAINABLE_BRANCHES for part in n.split("."))}

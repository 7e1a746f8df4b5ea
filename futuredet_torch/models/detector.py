"""Detector assembly: points -> pillar canvas -> RPN -> CenterHead.

Port of `futuredet_tpu/models/detector.py` for the pillar path (reference
`det3d/models/detectors/point_pillars.py`). Submodules are named `reader`,
`neck` and `bbox_head` so that `state_dict()` keys are the reference det3d
keys and a reference `.pth` loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..config import ExperimentConfig
from .backbone2d import RPN
from .center_head import CenterHead
from .layers import init_weights_
from .readers import PillarFeatureNetDirect


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card. Raises when CUDA is asked for and absent, so a
    caller never runs on the CPU without saying so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


class PointPillarsDetector(nn.Module):
    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        if cfg.model.compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype={cfg.model.compute_dtype!r}: the port runs "
                "fp32 only (bf16 towers are queued in ROADMAP.md)")
        self.cfg = cfg
        c = cfg
        gx, gy, _ = c.voxel.grid_size
        self.reader = PillarFeatureNetDirect(
            num_input_features=c.model.num_input_features,
            num_filters=c.model.pillar_filters,
            voxel_size=c.voxel.voxel_size[:2], pc_range=c.voxel.pc_range,
            grid_hw=(gy, gx),
            pad_floor_cap=(c.voxel.max_points_per_voxel
                           if c.model.pfn_pad_floor else 0))
        r = c.model.rpn
        self.neck = RPN(c.model.pillar_filters[-1], layer_nums=r.layer_nums,
                        ds_strides=r.ds_strides, ds_filters=r.ds_filters,
                        us_strides=r.us_strides, us_filters=r.us_filters)
        self.bbox_head = CenterHead(c.model.head)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor
                ) -> List[Dict[str, torch.Tensor]]:
        """points (B, P, F) f32, points_valid (B, P) bool -> per task a dict
        of NHWC head maps."""
        canvas = self.reader(points, points_valid)            # (B, H, W, C)
        x = self.neck(canvas.permute(0, 3, 1, 2))
        return self.bbox_head(x)


def build_detector(cfg: ExperimentConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> PointPillarsDetector:
    """The single-stage pillar detector in eval mode on `device` (default:
    the card), with LeCun-normal weights from `torch.Generator(seed)`."""
    dev = resolve_device(device)
    if cfg.model.two_stage_refine:
        raise NotImplementedError(
            "two-stage refinement is not ported yet (ROADMAP.md, queue 1: "
            "long tail, models/two_stage.py)")
    if cfg.model.detector != "pointpillars":
        raise NotImplementedError(
            "the sparse VoxelNet detector is not ported yet (ROADMAP.md, "
            "queue 1: ops/voxelize.py, ops/sparse_conv.py, models/middle.py "
            "and kernel K2)")
    model = PointPillarsDetector(cfg)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model.bbox_head.reset_hm_bias()
    return model.to(dev).eval()

"""Detector assembly: points -> BEV features -> RPN -> CenterHead.

Port of `futuredet_tpu/models/detector.py`: the pillar path (reference
`det3d/models/detectors/point_pillars.py`) and the sparse VoxelNet path
(`det3d/models/detectors/voxelnet.py`). Submodules are named `reader`,
`backbone`, `neck` and `bbox_head` so that `state_dict()` keys are the
reference det3d keys and a reference `.pth` loads with
`load_state_dict(strict=True)`; VoxelNet's `z_crush` is the port's own
(the reference `backbone.extra_conv` folds into it,
`utils/convert_checkpoint.py::_compose_extra_conv`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..config import ExperimentConfig
from ..ops.sparse_conv import out_dims_of
from ..ops.voxelize import PointVoxelMap, point_voxel_map, run_means
from .backbone2d import RPN
from .center_head import CenterHead
from .layers import ConvBNReLU, init_weights_
from .middle import SparseConv, SparseMiddleEncoder, stage_pads
from .readers import PillarFeatureNetDirect

# config values that only choose among exact TPU formulations of the same
# sparse conv sums; every one of them runs kernel K2 here
EXACT_GATHER_ALGOS = ("xpack", "loop", "stacked", "window", "hybrid")


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


class VoxelNetDetector(nn.Module):
    """Mean-VFE voxels -> sparse middle encoder -> z_crush -> RPN ->
    CenterHead (ref det3d/models/detectors/voxelnet.py + scn.py). After a
    forward, `num_voxels` holds the voxels per sample and
    `backbone.site_counts` the active sites per stage."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        m = cfg.model
        if m.compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype={m.compute_dtype!r}: the port runs fp32 only "
                "(bf16 towers are queued in ROADMAP.md)")
        if m.middle != "sparse":
            raise NotImplementedError(
                f"middle={m.middle!r}: the dense BEV fallback tower "
                "(_dense_path) is not ported yet (ROADMAP.md, queue 1: "
                "VoxelNet dense middle forms)")
        if m.middle_dense_from_stage is not None:
            raise NotImplementedError(
                "middle_dense_from_stage: the masked dense stages "
                "(DenseConv3d, DenseBasicBlock) are not ported yet "
                "(ROADMAP.md, queue 1: VoxelNet dense middle forms)")
        if m.middle_gather_algo not in EXACT_GATHER_ALGOS \
                or m.middle_sparse_dtype is not None:
            raise NotImplementedError(
                f"middle_gather_algo={m.middle_gather_algo!r}, "
                f"middle_sparse_dtype={m.middle_sparse_dtype!r}: the bf16 "
                "sparse path is not ported yet (ROADMAP.md, queue 1: "
                "compute_dtype bfloat16 and the lossy knobs)")
        self.cfg = cfg
        gx, gy, gz = cfg.voxel.grid_size
        self.backbone = SparseMiddleEncoder(
            num_input_features=m.num_input_features,
            channels=m.middle_channels, grid_zyx=(gz + 1, gy, gx))
        dims = self.backbone.grid_zyx
        for s in range(1, 4):
            dims = out_dims_of(dims, stage_pads(s, dims))
        self.z_crush = ConvBNReLU(dims[0] * m.middle_channels[-1],
                                  m.rpn.in_channels, 1, 1, bias=False)
        r = m.rpn
        self.neck = RPN(r.in_channels, layer_nums=r.layer_nums,
                        ds_strides=r.ds_strides, ds_filters=r.ds_filters,
                        us_strides=r.us_strides, us_filters=r.us_filters)
        self.bbox_head = CenterHead(m.head)
        self.num_voxels: List[int] = []

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor
                ) -> List[Dict[str, torch.Tensor]]:
        """points (B, P, F) f32, points_valid (B, P) bool -> per task a dict
        of NHWC head maps."""
        feats, vm = self.voxelize(points, points_valid)
        bev, zmask = self.backbone(feats, vm.coords, vm.batch,
                                   points.shape[0])
        return self.bbox_head(self.neck(self.crush(bev, zmask)))

    def voxelize(self, points: torch.Tensor, points_valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, PointVoxelMap]:
        """Mean features (N, F) of the batch's voxels and their map, under
        the voxel budget of the mode (`max_voxels_train` in training)."""
        v = self.cfg.voxel
        vm = point_voxel_map(points, points_valid, v.pc_range, v.voxel_size,
                             grid_size=v.grid_size,
                             max_voxels=(v.max_voxels_train if self.training
                                         else v.max_voxels_eval),
                             max_points=v.max_points_per_voxel)
        self.num_voxels = vm.num_voxels.tolist()
        return run_means(vm), vm

    def crush(self, bev: torch.Tensor, zmask: torch.Tensor) -> torch.Tensor:
        """(B, Y, X, Z*C) middle output -> (B, rpn.in_channels, Y, X)."""
        x = self.z_crush(bev.permute(0, 3, 1, 2))
        # re-mask with the ref extra_conv's active sites: spconv .dense()
        # leaves them 0, the BN + ReLU above does not. Channel j carries
        # z-slice d = j % Dz in the reference's C-major layout
        Dz = zmask.shape[-1]
        zm = zmask.permute(0, 3, 1, 2).to(x.dtype)             # (B, Dz, Y, X)
        if x.shape[1] % Dz == 0:
            return x * zm.repeat(1, x.shape[1] // Dz, 1, 1)
        return x * zm.amax(1, keepdim=True)


def build_detector(cfg: ExperimentConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> nn.Module:
    """The single-stage detector of `cfg.model.detector` ("pointpillars" or
    "voxelnet") in eval mode on `device` (default: the card), with
    LeCun-normal dense weights and the sparse convs' uniform init drawn
    from `torch.Generator(seed)`."""
    dev = resolve_device(device)
    if cfg.model.two_stage_refine:
        raise NotImplementedError(
            "two-stage refinement is not ported yet (ROADMAP.md, queue 1: "
            "long tail, models/two_stage.py)")
    if cfg.model.detector == "pointpillars":
        model = PointPillarsDetector(cfg)
    elif cfg.model.detector == "voxelnet":
        model = VoxelNetDetector(cfg)
    else:
        raise ValueError(f"unknown detector {cfg.model.detector!r}")
    g = torch.Generator().manual_seed(seed)
    init_weights_(model, g)
    for m in model.modules():
        if isinstance(m, SparseConv):
            m.reset_parameters(g)
    model.bbox_head.reset_hm_bias()
    return model.to(dev).eval()

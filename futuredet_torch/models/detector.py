"""Detector assembly: points -> BEV features -> RPN -> CenterHead.

Port of `futuredet_tpu/models/detector.py`: the pillar path (reference
`det3d/models/detectors/point_pillars.py`) and the sparse VoxelNet path
(`det3d/models/detectors/voxelnet.py`). Submodules are named `reader`,
`backbone`, `neck` and `bbox_head` so that `state_dict()` keys are the
reference det3d keys and a reference `.pth` loads with
`load_state_dict(strict=True)`; VoxelNet's `z_crush` is the port's own
(the reference `backbone.extra_conv` folds into it,
`utils/convert_checkpoint.py::_compose_extra_conv`). `build_detector` of a
`two_stage_refine` config builds `models/two_stage.py::TwoStageDetector`
around one of these (`first_stage`), whose neck output it reads through
`return_bev`.

The serving knobs of the JAX package run here too: `compute_dtype=
"bfloat16"` (bf16 z_crush, RPN and head towers, `models/layers.py`),
`middle_gather_algo`, `middle_sparse_dtype` ("bfloat16", "bf16_packed")
and the dense middle forms (`middle_dense_from_stage`,
`middle_dense_dtype`; `models/middle.py`) and `middle="dense"`, the
JAX `_dense_path` (mean VFE, `voxel_embed`, 8 z-groups scattered at
stride 4, `mid_conv0/1`, then the RPN and the head, all fp32 whatever
`compute_dtype` says, as there). They train too, with the JAX package's
dtypes in the backward (`models/layers.py`, `ops/sparse_conv.py::
SparseConvFunction`, `models/middle.py::SparseConv.dense`); `window*`,
`hybrid` and `bf16_packed` train as fp32 (`SparseMiddleEncoder.conv_algo`,
`conv_form`).

Spatial sharding (`lay_out_space_`, the JAX `canvas_sharding`
constraint, futuredet_tpu/models/detector.py:100-104,199-200): the prefix
before the canvas (the pillar reader; voxelize and the sparse middle or
the dense forms) runs whole on every rank of a space group, on the same
scene, and each rank cuts its band of the canvas's rows (the RPN's band
rule, `models/backbone2d.py`); z_crush with its re-mask, the RPN and the
head run on the band (`models/layers.py`), and the head maps are gathered
whole to every rank (`parallel/collectives.py::gather_rows`) for the
decode and the loss. The band's backward hands the prefix only its rows'
cotangent, so each rank's gradients are its band's share, summed over the
space group by the train step. `dcn_head`'s deformable convs sample the
head's input gathered whole (`models/center_head.py::DCNSepHead`). A
two-stage model's first stage is banded so, with its neck output gathered
whole for the RoI stage, which every rank runs whole on the gathered maps
(the JAX GSPMD step's replicated outputs): decode with K1, pooling and
the RoI head, whose gradients the step averages over the space group
(`whole_parameters`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..config import ExperimentConfig
from ..ops.sparse_conv import out_dims_of
from ..ops.voxelize import PointVoxelMap, point_voxel_map, run_means
from ..parallel.collectives import gather_rows
from .backbone2d import RPN
from .center_head import CenterHead
from .layers import (ConvBNReLU, SplitInputConv2d, init_weights_,
                     lay_out_rows_, torch_dtype)
from .middle import SparseConv, SparseMiddleEncoder, stage_pads
from .readers import PillarFeatureNetDirect

# middle_gather_algo values: exact TPU formulations of the same sparse conv
# sums, and window_bf16, the bf16 mode of the Pallas kernel (K2's bf16
# family here)
GATHER_ALGOS = ("xpack", "loop", "stacked", "window", "window_bf16",
                "hybrid")
SPARSE_DTYPES = (None, "bfloat16", "bf16_packed")
DENSE_ZGROUPS, DENSE_EMBED = 8, 32     # the JAX _dense_path's z-groups, width


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


def _with_bev(preds: List[Dict[str, torch.Tensor]], x: torch.Tensor,
              return_bev: bool):
    """preds, or (preds, the NCHW neck output `x` as an NHWC view): the JAX
    detectors' `return_bev` (futuredet_tpu/models/detector.py:117-119)."""
    return (preds, x.permute(0, 2, 3, 1)) if return_bev else preds


class _Tower(nn.Module):
    """What the detectors share past the canvas: the neck and the head,
    on the whole canvas or, under a space layout, on this rank's band."""
    space = None

    def canvas_band(self, rows: int) -> Tuple[int, int]:
        """This rank's band of a canvas of `rows` rows (the neck's
        input)."""
        coarse, rest = divmod(rows, self.neck.in_rows)
        if rest:
            raise ValueError(f"a canvas of {rows} rows is not a whole "
                             f"number of the RPN's coarsest rows "
                             f"({self.neck.in_rows} each)")
        return self.space.band(coarse, self.neck.in_rows)

    def tower(self, x: torch.Tensor, bev_map: Optional[torch.Tensor],
              return_bev: bool, rows: int):
        """x: the NCHW canvas (its band under a space layout, of a canvas
        of `rows` rows) -> the head maps of the whole canvas (and with
        `return_bev` the whole neck output, gathered under a layout)."""
        if self.space is None:
            x = self.neck(x)
            return _with_bev(self.bbox_head(x, bev_map), x, return_bev)
        coarse = rows // self.neck.in_rows
        x = self.neck(x)
        if bev_map is not None:
            a, b = self.space.band(coarse, self.neck.out_rows)
            bev_map = bev_map[:, a:b]
        bands = self.space.bands(coarse, self.neck.out_rows)
        # the forecast features feed the next head inside the band; the
        # decode and the loss read the rest
        preds = [{k: gather_rows(v, 1, bands, self.space)
                  for k, v in task.items() if k != "feats"}
                 for task in self.bbox_head(x, bev_map, bands)]
        if return_bev:
            # the RoI stage pools the whole neck output on every rank (its
            # training reads it detached)
            x = gather_rows(x, 2, bands, self.space)
        return _with_bev(preds, x, return_bev)


class PointPillarsDetector(_Tower):
    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        cd = torch_dtype(c.model.compute_dtype)
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
                        us_strides=r.us_strides, us_filters=r.us_filters,
                        compute_dtype=cd)
        self.bbox_head = CenterHead(c.model.head, compute_dtype=cd)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                bev_map: Optional[torch.Tensor] = None,
                return_bev: bool = False):
        """points (B, P, F) f32, points_valid (B, P) bool, and the (B, H, W,
        1) ego map of a bev_map config -> per task a dict of NHWC head
        maps; with `return_bev`, (those, the (B, H, W, C) neck output) for
        the second stage's pooling."""
        canvas = self.reader(points, points_valid)            # (B, H, W, C)
        x = canvas.permute(0, 3, 1, 2)
        rows = x.shape[2]
        if self.space is not None:
            a, b = self.canvas_band(rows)
            x = x[:, :, a:b]
        return self.tower(x, bev_map, return_bev, rows)


class VoxelNetDetector(_Tower):
    """Mean-VFE voxels -> sparse middle encoder -> z_crush -> RPN ->
    CenterHead (ref det3d/models/detectors/voxelnet.py + scn.py), or with
    `middle="dense"` the JAX package's dense BEV tower. After a forward,
    `num_voxels` holds the voxels per sample and (sparse middle)
    `backbone.site_counts` the active sites per stage."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        m = cfg.model
        if m.middle not in ("sparse", "dense"):
            raise ValueError(f"middle={m.middle!r}: 'sparse' or 'dense'")
        if m.middle_gather_algo not in GATHER_ALGOS:
            raise ValueError(f"middle_gather_algo={m.middle_gather_algo!r}:"
                             f" one of {GATHER_ALGOS}")
        if m.middle_sparse_dtype not in SPARSE_DTYPES:
            raise ValueError(f"middle_sparse_dtype="
                             f"{m.middle_sparse_dtype!r}: one of "
                             f"{SPARSE_DTYPES}")
        self.cfg = cfg
        gx, gy, gz = cfg.voxel.grid_size
        r = m.rpn
        rpn = dict(layer_nums=r.layer_nums, ds_strides=r.ds_strides,
                   ds_filters=r.ds_filters, us_strides=r.us_strides,
                   us_filters=r.us_filters)
        self._num_voxels = None
        if m.middle == "dense":
            # futuredet_tpu/models/detector.py:229-280: no compute_dtype
            self.voxel_embed = nn.Linear(m.num_input_features, DENSE_EMBED)
            # 256 -> 128 3x3 at Y/4: split, as the RPN stem, so that cuDNN
            # takes no FFT algorithm (layers.py::SplitInputConv2d)
            self.mid_conv0 = ConvBNReLU(DENSE_ZGROUPS * DENSE_EMBED, 128, 3,
                                        1, bias=False, conv=SplitInputConv2d)
            self.mid_conv1 = ConvBNReLU(128, 256, 3, 2, bias=False)
            self.neck = RPN(256, **rpn)
            self.bbox_head = CenterHead(m.head)
            return
        cd = torch_dtype(m.compute_dtype)
        self.backbone = SparseMiddleEncoder(
            num_input_features=m.num_input_features,
            channels=m.middle_channels, grid_zyx=(gz + 1, gy, gx),
            gather_algo=m.middle_gather_algo,
            xpack_max_cin=m.middle_xpack_max_cin,
            sparse_dtype=(torch_dtype(m.middle_sparse_dtype)
                          if m.middle_sparse_dtype != "bf16_packed"
                          else None),
            packed_pairs=m.middle_sparse_dtype == "bf16_packed",
            dense_from_stage=m.middle_dense_from_stage,
            dense_dtype=torch_dtype(m.middle_dense_dtype))
        dims = self.backbone.grid_zyx
        for s in range(1, 4):
            dims = out_dims_of(dims, stage_pads(s, dims))
        self.z_crush = ConvBNReLU(dims[0] * m.middle_channels[-1],
                                  m.rpn.in_channels, 1, 1, bias=False,
                                  compute_dtype=cd)
        self.neck = RPN(r.in_channels, **rpn, compute_dtype=cd)
        self.bbox_head = CenterHead(m.head, compute_dtype=cd)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                bev_map: Optional[torch.Tensor] = None,
                return_bev: bool = False):
        """points (B, P, F) f32, points_valid (B, P) bool, and the (B, H, W,
        1) ego map of a bev_map config -> per task a dict of NHWC head
        maps; with `return_bev`, (those, the (B, H, W, C) neck output)."""
        feats, vm = self.voxelize(points, points_valid)
        if self.cfg.model.middle == "dense":
            x = self.dense_bev(feats, vm, points.shape[0])
            rows = x.shape[2]
            if self.space is not None:
                a, b = self.canvas_band(rows)
                x = x[:, :, a:b]
        else:
            bev, zmask = self.backbone(feats, vm.coords, vm.batch,
                                       points.shape[0])
            rows = bev.shape[1]
            if self.space is not None:
                a, b = self.canvas_band(rows)
                bev, zmask = bev[:, a:b], zmask[:, a:b]
            x = self.crush(bev, zmask)
        return self.tower(x, bev_map, return_bev, rows)

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
        if not torch.compiler.is_exporting():   # a program keeps no state
            self._num_voxels = vm.num_voxels
        return run_means(vm), vm

    @property
    def num_voxels(self) -> List[int]:
        """The voxels per sample of the last forward ([] before one),
        copied to the host when read rather than in the forward."""
        return [] if self._num_voxels is None else self._num_voxels.tolist()

    def dense_bev(self, feats: torch.Tensor, vm: PointVoxelMap,
                  batch_size: int) -> torch.Tensor:
        """`middle="dense"` (futuredet_tpu/models/detector.py:246-273):
        voxel means (N, F) -> `voxel_embed` -> summed into 8 z-groups of a
        canvas at 1/4 of the grid's xy, channel z-group * 32 + c ->
        mid_conv0, mid_conv1 (stride 2) -> (B, 256, Y/8, X/8)."""
        gx, gy, gz = self.cfg.voxel.grid_size
        G, C = DENSE_ZGROUPS, DENSE_EMBED
        H4, W4 = gy // 4, gx // 4
        z, y, x = vm.coords.to(torch.int64).unbind(-1)
        zg = torch.clamp(torch.div(z * G, gz, rounding_mode="floor"), 0,
                         G - 1)
        idx = ((vm.batch * G + zg) * H4 + torch.div(
            y, 4, rounding_mode="floor")) * W4 + torch.div(
                x, 4, rounding_mode="floor")
        emb = self.voxel_embed(feats)
        canvas = emb.new_zeros(batch_size * G * H4 * W4, C).index_add_(
            0, idx, emb)
        x = canvas.view(batch_size, G, H4, W4, C).permute(
            0, 1, 4, 2, 3).reshape(batch_size, G * C, H4, W4)
        return self.mid_conv1(self.mid_conv0(x))

    def crush(self, bev: torch.Tensor, zmask: torch.Tensor) -> torch.Tensor:
        """(B, Y, X, Z*C) middle output -> (B, rpn.in_channels, Y, X)."""
        x = self.z_crush(bev.permute(0, 3, 1, 2))
        # re-mask with the ref extra_conv's active sites: spconv .dense()
        # leaves them 0, the BN + ReLU above does not. Channel j carries
        # z-slice d = j % Dz in the reference's C-major layout; the mask
        # multiplies in the activation's dtype (bf16 under compute_dtype)
        Dz = zmask.shape[-1]
        zm = zmask.permute(0, 3, 1, 2).to(x.dtype)             # (B, Dz, Y, X)
        if x.shape[1] % Dz == 0:
            return x * zm.repeat(1, x.shape[1] // Dz, 1, 1)
        return x * zm.amax(1, keepdim=True)


def build_single_stage(cfg: ExperimentConfig) -> nn.Module:
    """The detector of `cfg.model.detector` ("pointpillars" or
    "voxelnet"), untouched by any init."""
    if cfg.model.detector == "pointpillars":
        return PointPillarsDetector(cfg)
    if cfg.model.detector == "voxelnet":
        return VoxelNetDetector(cfg)
    raise ValueError(f"unknown detector {cfg.model.detector!r}")


def init_single_stage_(model: nn.Module, g: torch.Generator) -> None:
    """The seeded init of a single-stage detector, drawn from `g`:
    LeCun-normal dense weights in module order, then the sparse convs'
    uniform init, then the head's non-default inits."""
    init_weights_(model, g)
    for m in model.modules():
        if isinstance(m, SparseConv):
            m.reset_parameters(g)
    model.bbox_head.reset_init()


def lay_out_space_(model: nn.Module, space) -> nn.Module:
    """`model`, a detector of `build_detector`, under the space layout
    `space` (`parallel/mesh.py::SpaceGroup`; nothing for None): the
    prefix whole on every rank, the rest banded; a two-stage model's
    first stage so, its RoI head whole on every rank (`whole_parameters`).
    """
    if space is None:
        return model
    model.space = space
    if hasattr(model, "first_stage"):
        lay_out_space_(model.first_stage, space)
        return model
    lay_out_rows_(model, space, banded=False)
    for part in ("z_crush", "neck", "bbox_head"):
        if hasattr(model, part):
            lay_out_rows_(getattr(model, part), space, banded=True)
    return model


def whole_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that every rank of a space group computes whole,
    none outside a layout: a two-stage model's RoI head, which reads the
    gathered maps. The train step averages their gradients over the space
    group where it sums the bands' shares
    (`parallel/collectives.py::average_gradients_`)."""
    if getattr(model, "space", None) is None or \
            not hasattr(model, "roi_head"):
        return []
    return list(model.roi_head.parameters())


def build_detector(cfg: ExperimentConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> nn.Module:
    """The detector of `cfg` in eval mode on `device` (default: the card),
    its weights drawn from `torch.Generator(seed)`: the single-stage
    detector of `cfg.model.detector` ("pointpillars" or "voxelnet"), or
    with `two_stage_refine` a `models/two_stage.py::TwoStageDetector`
    whose first stage draws as the single-stage detector does, and its RoI
    head after it."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    if cfg.model.two_stage_refine:
        from .two_stage import TwoStageDetector
        model = TwoStageDetector(cfg)
        init_single_stage_(model.first_stage, g)
        init_weights_(model.roi_head, g)
    else:
        model = build_single_stage(cfg)
        init_single_stage_(model, g)
    return model.to(dev).eval()

"""Configuration system: typed dataclasses + a named-config registry.

The port's own copy of `futuredet_tpu/config.py`, kept identical so that both
packages build the same model from the same name. Mirrors the public config
surface of the reference (`configs/centerpoint/*.py`, model names resolved by
the reference `train.py:23-25` / `evaluate.py:136-138`) as plain frozen
dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _t(x) -> tuple:
    return tuple(x)


@dataclass(frozen=True)
class VoxelConfig:
    """Voxelization grid (ref: configs/.../n3dtf voxel_generator, lines 160-166)."""
    pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: Tuple[float, ...] = (0.075, 0.075, 0.2)
    max_points_per_voxel: int = 10
    max_voxels_train: int = 120000
    max_voxels_eval: int = 160000
    # total points kept after sweep aggregation (fixed-shape input budget)
    max_points: int = 300000

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        gx = round((self.pc_range[3] - self.pc_range[0]) / self.voxel_size[0])
        gy = round((self.pc_range[4] - self.pc_range[1]) / self.voxel_size[1])
        gz = round((self.pc_range[5] - self.pc_range[2]) / self.voxel_size[2])
        return (gx, gy, gz)


@dataclass(frozen=True)
class HeadSpec:
    """One regression branch of a SepHead: (out_channels, num_convs).

    ref: common_heads in configs (e.g. `reg: (2, 2)`), consumed at
    det3d/models/bbox_heads/center_head.py:129-152.
    """
    channels: int
    num_convs: int


@dataclass(frozen=True)
class HeadConfig:
    """CenterHead mode flags + shapes (ref: center_head.py:233-334).

    tasks: one class group per SepHead. The forecast pipeline (like every
    shipped reference config, SURVEY.md §2.8) uses a single single-class
    group — the reference's own predict() label bookkeeping is only coherent
    in that regime because pseudo-task labels are overloaded with the
    timestep index (ref center_head.py:566,686-690).
    """
    tasks: Tuple[Tuple[str, ...], ...] = (("car",),)
    in_channels: int = 512
    share_conv_channel: int = 64
    common_heads: Tuple[Tuple[str, Tuple[int, int]], ...] = (
        ("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)),
        ("rot", (2, 2)), ("vel", (2, 2)),
    )
    weight: float = 0.25                       # hm vs. loc loss weight
    code_weights: Tuple[float, ...] = (1.0,) * 10
    timesteps: int = 1
    target_timesteps: int = 7
    # mode flags (ref: center_head.py:258-271)
    two_stage: bool = False
    reverse: bool = False
    sparse: bool = False
    dense: bool = False
    bev_map: bool = False
    forecast_feature: bool = False
    classify: bool = False
    wide_head: bool = False
    # DCN feature-adaption head (ref center_head.py:176-228,317-318; every
    # shipped reference config has dcn_head=False)
    dcn_head: bool = False
    init_bias: float = -2.19
    num_hm_conv: int = 2

    @property
    def standard(self) -> bool:
        return not (self.reverse or self.sparse or self.dense
                    or self.classify or self.wide_head)

    @property
    def multitask(self) -> bool:
        """Classic CenterPoint class groups: a standard head of several
        tasks, one SepHead per group, detections labeled with global class
        ids and scored without forecast linking. (The port's own property;
        the JAX package spells it out where it needs it.)"""
        return self.standard and len(self.tasks) > 1

    @property
    def num_classes(self) -> Tuple[int, ...]:
        """Per-task heatmap channel counts (ref: center_head.py:321-334)."""
        if self.sparse:
            return (1,) * 2
        if self.dense:
            return (1,) * self.timesteps
        if self.classify:
            return (3,) * self.timesteps
        if self.wide_head:
            return (7,)
        return tuple(len(t) for t in self.tasks)

    @property
    def effective_share_channel(self) -> int:
        return 512 if self.wide_head else self.share_conv_channel

    @property
    def code_weights_forecast(self) -> Tuple[float, ...]:
        """Future-timestep weights: zero all but velocity (ref: :280-288)."""
        mask = [0, 0, 0, 0, 0, 0, 1, 1, 0, 0]
        return tuple(w * m for w, m in zip(self.code_weights, mask))

    @property
    def code_weights_two_stage(self) -> Tuple[float, ...]:
        """TWO_STAGE fine-tuning weights: vel + rot only, applied to EVERY
        timestep (ref :286: code_weights_two_stage_forecast = [0]*6 +
        [1,1,1,1], used at :509-511 for all i)."""
        return (0.0,) * 6 + (1.0,) * 4


@dataclass(frozen=True)
class AssignerConfig:
    """Target assignment (ref: configs assigner dict + AssignLabel)."""
    out_size_factor: int = 8
    gaussian_overlap: float = 0.1
    max_objs: int = 500
    min_radius: int = 2
    radius_mult: bool = True
    sampler_type: str = "standard"   # or "trajectory"


@dataclass(frozen=True)
class NMSConfig:
    """ref: test_cfg.nms in configs."""
    pre_max_size: int = 1000
    post_max_size: int = 83
    iou_threshold: float = 0.2


@dataclass(frozen=True)
class TestConfig:
    post_center_limit_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    max_per_img: int = 500
    score_threshold: float = 0.1
    nms: NMSConfig = field(default_factory=NMSConfig)
    circular_nms: bool = False
    min_radius: Tuple[float, ...] = (4.0,)


@dataclass(frozen=True)
class RPNConfig:
    """BEV neck (ref: configs model.neck)."""
    layer_nums: Tuple[int, ...] = (5, 5)
    ds_strides: Tuple[int, ...] = (1, 2)
    ds_filters: Tuple[int, ...] = (128, 256)
    us_strides: Tuple[int, ...] = (1, 2)
    us_filters: Tuple[int, ...] = (256, 256)
    in_channels: int = 256


@dataclass(frozen=True)
class ModelConfig:
    detector: str = "voxelnet"        # "voxelnet" | "pointpillars"
    reader: str = "mean_vfe"          # "mean_vfe" | "pillar_feature_net"
    # reference PFN padding-floor quirk (readers.PillarFeatureNetDirect
    # docstring): required for converted-reference-checkpoint parity; costs
    # ~1 ms/sample of per-pillar phantom-row work. Models trained in this
    # framework are self-consistent with it off.
    pfn_pad_floor: bool = True
    num_input_features: int = 5
    pillar_filters: Tuple[int, ...] = (64,)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    # second-stage RoI refinement (ref detectors/two_stage.py:9-193): decode
    # first-stage proposals inside the forward, pool BEV features at 5 box
    # points, refine score + residuals with the RoI head
    two_stage_refine: bool = False
    # sparse middle encoder (ref: scn.py:98-146)
    middle: str = "sparse"            # "sparse" | "dense" (BEV fallback tower)
    middle_channels: Tuple[int, ...] = (16, 32, 64, 128)
    # active-site capacity CEILING per stage (static buffers for the
    # gather-scatter submanifold convs). The detector sizes each stage at
    # min(middle_vmax[s], ceil(middle_growth[s] * voxelizer cap)) so the
    # buffers track the input budget instead of paying a fixed worst case.
    # At the 120k TRAIN budget these ceilings bind below the growth rule;
    # round-5 sweep of the physical families at train scale (5 scenes,
    # docs/ROADMAP.md): heavy-GT-AUG stage-1 peaks at 106.1k sites — the
    # old ceiling 96000 clipped 10.1k of them. 112000 = observed max +
    # ~5% margin; stages 2/3 peak at 56.8k/31.1k (11%/35% margin kept).
    middle_vmax: Tuple[int, ...] = (120000, 112000, 63000, 42000)
    # generative strided-conv site growth bound per downsample stage,
    # relative to the VOXELIZER cap. Round-4 envelope (scripts/occupancy.py
    # sweep over the physical scene families lidar/urban/highway/gtaug x 3
    # seeds): max observed growth (1.681, 0.982, 0.62) — the heavy GT-AUG
    # paste family peaks stage 1 (the round-3 bound 1.6 clipped it by 2.4k
    # sites); bounds below are observed-max + margin, guarded by
    # tests/test_capacity.py::test_scene_families_zero_drops. Isolated-
    # point synthetic worst cases (uniform: 3.3x/4.4x/2.1x) exceed any
    # practical fixed capacity and would clip —
    # **None disables the growth rule and honors middle_vmax exactly**
    # (use for explicitly-sized test/oracle configs). Either way the
    # sparse path counts clipped sites per stage and sows them as
    # intermediates "dropped_sites" (see models/middle.py) — the reference
    # spconv never drops sites (scn.py:109-146 allocates per-scene), so a
    # nonzero counter means the run has left reference semantics.
    middle_growth: Optional[Tuple[float, ...]] = (1.8, 1.05, 0.70)
    # hybrid tail: stages >= this run as masked dense 3D convs (MXU-bound)
    # instead of 27-way gathers (HBM-latency-bound); None = fully sparse
    middle_dense_from_stage: Optional[int] = None
    # dtype for dense-stage conv contractions ("bfloat16" | None=fp32)
    middle_dense_dtype: Optional[str] = None
    # sparse-stage gather strategy: "xpack" (x-packed 9-probe tables +
    # 3x-wide slab gathers for stages with Cin <= middle_xpack_max_cin,
    # stacked on unpacked tables beyond — the v5e winner, inference-only:
    # training downgrades to stacked custom-VJP paths), "loop" (27 small-K
    # matmuls), "stacked" (one gather + one K*Cin-deep MXU matmul),
    # "window"/"window_bf16" (Pallas one-hot row-select, inference-only and
    # unbatched), or "hybrid" (window for Cin<=16, stacked otherwise)
    middle_gather_algo: str = "xpack"
    # cell->site map representation for the xpack table builds at EVAL:
    # "ov" (default) = full (R, 128) index-row maps. "bitmap" =
    # popcount-bitmap rows (8 int32 lanes per 126-cell row: cumulative
    # site count + 128-bit presence mask; site index = cum + popcount
    # rank — exact because sorted sites covered by a row are consecutive;
    # shrinks the stage-0 map 345 MB -> 22 MB). Round-5 back-to-back e2e
    # A/B: bitmap 362.5/363.5 (uniform/realistic) vs ov 354.2/369.1 —
    # +8 on the clustered-blob scene, -6 on the lidar scene, net wash;
    # the isolated ~3 ms probe-penalty saving does NOT compose in-graph
    # ("bitmap0" — stage 0 only — pinned the lidar loss to stage 0: the
    # penalty is page-locality, and concentrated lidar probes keep the ov
    # map's hot pages resident). ov stays the default for the better
    # physical-scene number; the knob is exact (bit-identical tables,
    # tests/test_sparse_conv.py) either way.
    # Training always builds ov maps (the strided-conv custom VJPs probe
    # them for inverse tables).
    middle_map_format: str = "ov"
    # widest Cin the x-packed gather path covers. Round-4 re-sweep at
    # honest caps (scripts/probe_wide_xpack.py): conv_x3 wins at Cin=64
    # (1.71 vs 2.59 ms stacked, V=31.5k — the old Cin<=32 verdict predates
    # the free routing einsums); stacked stays ahead at Cin=128 (1.21 vs
    # 1.66: 512 B rows stream at ~2 ns/row, 1536 B xpack rows hit the wide-
    # row dip). e2e voxelnet 367.9 -> 383.1 sweeps/s.
    middle_xpack_max_cin: int = 64
    # sparse-stage activation dtype (None = fp32 reference-parity numerics,
    # the default). "bf16_packed": gather int32 bf16-PAIR rows at the
    # Cin=64 stages, shift-unpacked to fp32 before the matmul
    # (ops.sparse_conv.conv_x3_packed). Round-4's isolated probe measured
    # the conv 1.81 -> 1.36 ms (probe_shift_unpack.py) and VERDICT r4
    # asked for promotion — but the round-5 e2e A/B (BENCH run, same HEAD,
    # only this knob flipped) measured voxelnet 369 -> 219 sweeps/s: the
    # packed conv REGRESSES ~7 ms/conv inside the full encoder graph
    # (pack/bitcast chains defeat XLA fusion around the residual blocks).
    # Promotion retracted; knob retained with this record. "bfloat16":
    # plain bf16 conv-input cast — measured NO gather win on v5e (row
    # gathers cost per <=128-LANE row, dtype-independent).
    middle_sparse_dtype: Optional[str] = None
    # computation dtype for the dense BEV towers (RPN + CenterHead + z_crush;
    # params and head outputs stay fp32). "bfloat16" halves their MXU time —
    # the TPU-native serving mode; None = fp32 reference-parity numerics.
    compute_dtype: Optional[str] = None


@dataclass(frozen=True)
class OptimConfig:
    """One-cycle Adam (ref: configs optimizer/lr_config, n3dtf:231-238)."""
    lr_max: float = 1e-3
    moms: Tuple[float, float] = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    amsgrad: bool = False


@dataclass(frozen=True)
class TrainConfig:
    total_epochs: int = 20
    batch_size_per_device: int = 1
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    log_interval: int = 25
    checkpoint_interval_epochs: int = 1


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "nuscenes"
    nsweeps: int = 20
    class_names: Tuple[str, ...] = ("car",)
    root_path: str = ""
    sampler_type: str = "standard"
    # GT-AUG paste sampling (ref configs db_sampler, n3dtf:110-141): counts
    # per `{trajectory}_{class}` (trajectory sampler) or `{class}` (standard)
    # group. Consumed by data.gt_database.DataBaseSampler; built by the train
    # CLI whenever a dbinfos pkl sits next to --info_path.
    sample_groups: Tuple[Tuple[str, int], ...] = ()
    # ref db_prep_steps filter_by_min_num_points (n3dtf:132-136)
    gt_aug_min_points: int = 5
    # ref global_random_rotation_range_per_object (n3dtf:139, consumed at
    # sample_ops.py:318-323 via noise_per_object_v3_): re-place pasted
    # objects anywhere on their ego-circle. Every shipped reference config
    # sets [0, 0] = disabled; None keeps that default.
    gt_aug_global_rot_range: Optional[Tuple[float, float]] = None
    global_rot_noise: Tuple[float, float] = (-0.78539816, 0.78539816)
    global_scale_noise: Tuple[float, float] = (0.9, 1.1)
    global_translate_std: float = 0.5
    shuffle_points: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "forecast_n0"
    model: ModelConfig = field(default_factory=ModelConfig)
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    assigner: AssignerConfig = field(default_factory=AssignerConfig)
    test: TestConfig = field(default_factory=TestConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    timesteps: int = 1

    @property
    def feature_map_size(self) -> Tuple[int, int]:
        g = self.voxel.grid_size
        f = self.assigner.out_size_factor
        return (g[0] // f, g[1] // f)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Named configs mirroring the reference config matrix (SURVEY.md §2.8)
# ---------------------------------------------------------------------------

def _base(classname: str, timesteps: int, dense: bool, forecast_feats: bool,
          sampler_type: str, detector: str, bev_map: bool = False) -> ExperimentConfig:
    tasks = ((classname,),)
    if detector == "pointpillars":
        # ref: configs/.../pp_forecast_n3dtf:38-52,161-162: range ±51.2,
        # voxel 0.2m, PFN filters [64, 64]
        voxel = VoxelConfig(pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                            voxel_size=(0.2, 0.2, 8.0),
                            max_points_per_voxel=20,
                            max_voxels_train=30000, max_voxels_eval=60000)
        rpn = RPNConfig(layer_nums=(3, 5, 5), ds_strides=(2, 2, 2),
                        ds_filters=(64, 128, 256), us_strides=(0.5, 1, 2),
                        us_filters=(128, 128, 128), in_channels=64)
        head_in = 384
        pillar_filters = (64, 64)
        out_size_factor = 4
        reader = "pillar_feature_net"
    else:
        voxel = VoxelConfig()
        rpn = RPNConfig()
        head_in = 512
        out_size_factor = 8
        reader = "mean_vfe"
        pillar_filters = (64,)

    # vel weight 0.2 for the n0/n3 (non-dense) families (ref configs
    # nusc_centerpoint_forecast_n0_detection.py:59 vs n3dtf:59)
    code_weights = ((1.0,) * 6 + (0.2, 0.2) + (1.0,) * 2) if not dense \
        else (1.0,) * 10
    head = HeadConfig(
        tasks=tasks, in_channels=head_in, timesteps=timesteps,
        dense=dense, forecast_feature=forecast_feats, bev_map=bev_map,
        code_weights=code_weights,
    )
    # GT-AUG groups (ref configs n3dtf:110-123 / pedestrian_n3dtf:110-123)
    if sampler_type == "standard":
        groups = ((classname, 2),)
    else:
        groups = ((f"static_{classname}", 2),
                  (f"linear_{classname}", 4 if classname == "car" else 2),
                  (f"nonlinear_{classname}", 6 if classname == "car" else 4))
    return ExperimentConfig(
        model=ModelConfig(detector=detector, reader=reader, rpn=rpn, head=head,
                          pillar_filters=pillar_filters),
        voxel=voxel,
        assigner=AssignerConfig(out_size_factor=out_size_factor,
                                sampler_type=sampler_type),
        data=DataConfig(class_names=(classname,), sampler_type=sampler_type,
                        sample_groups=groups),
        timesteps=timesteps,
    )


def get_config(name: str) -> ExperimentConfig:
    """Resolve a reference model name (e.g. 'forecast_n3dtf') to a config.

    Naming mirrors the reference `train.py:23-25`:
    `{dataset}_centerpoint_{model}_detection`.
    """
    classname = "pedestrian" if "pedestrian" in name else "car"
    detector = "pointpillars" if name.startswith("pp_") else "voxelnet"
    key = name.replace("pp_", "").replace("pedestrian_", "")
    # `{model}_two_stage`: first stage + RoI refinement, trained with the
    # TWO_STAGE freeze schedule (ref TWO_STAGE flag in configs, consumed at
    # apis/train.py:353-356 + detectors/two_stage.py)
    two_stage = key.endswith("_two_stage")
    key = key.removesuffix("_two_stage")

    if key == "forecast_n0":
        cfg = _base(classname, 1, dense=False, forecast_feats=False,
                    sampler_type="standard", detector=detector)
    elif key == "forecast_n3":
        cfg = _base(classname, 7, dense=False, forecast_feats=False,
                    sampler_type="standard", detector=detector)
    elif key == "forecast_n3dtf":
        cfg = _base(classname, 7, dense=True, forecast_feats=True,
                    sampler_type="trajectory", detector=detector)
    elif key == "forecast_n3dtfm":
        cfg = _base(classname, 7, dense=True, forecast_feats=True,
                    sampler_type="trajectory", detector=detector, bev_map=True)
    elif key == "centerpoint_multitask":
        # classic CenterPoint: classes partitioned into per-SepHead groups
        # (ref center_head.py:321-323; standard nuScenes task split).
        # Detection-only — evaluated with the class-labeled metric path.
        cfg = _base("car", 1, dense=False, forecast_feats=False,
                    sampler_type="standard", detector=detector)
        tasks = (("car",), ("truck", "construction_vehicle"),
                 ("bus", "trailer"), ("barrier",),
                 ("motorcycle", "bicycle"), ("pedestrian", "traffic_cone"))
        names = tuple(n for t in tasks for n in t)
        cfg = cfg.replace(
            model=dataclasses.replace(
                cfg.model,
                head=dataclasses.replace(cfg.model.head, tasks=tasks)),
            data=dataclasses.replace(
                cfg.data, class_names=names,
                sample_groups=tuple((n, 2) for n in names)))
    else:
        raise KeyError(f"unknown config name: {name}")
    if two_stage:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, two_stage_refine=True,
            head=dataclasses.replace(cfg.model.head, two_stage=True)))
    return cfg.replace(name=name)


CONFIG_NAMES = [
    "forecast_n0", "forecast_n3", "forecast_n3dtf", "forecast_n3dtfm",
    "pedestrian_forecast_n0", "pedestrian_forecast_n3",
    "pedestrian_forecast_n3dtf", "pedestrian_forecast_n3dtfm",
    "pp_forecast_n3dtf", "pp_pedestrian_forecast_n3dtf",
    "centerpoint_multitask", "pp_centerpoint_multitask",
    "forecast_n3dtf_two_stage", "pp_forecast_n3dtf_two_stage",
]


def tiny_variant(cfg: ExperimentConfig) -> ExperimentConfig:
    """Shrunken geometry for smoke tests / CI: same structure (head modes,
    timesteps, detector), tiny grids and budgets."""
    pp = cfg.model.detector == "pointpillars"
    voxel = VoxelConfig(
        pc_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 3.0),
        voxel_size=(0.5, 0.5, 6.0) if pp else (0.5, 0.5, 0.5),
        max_points_per_voxel=8, max_voxels_train=512, max_voxels_eval=512,
        max_points=1024)
    rpn = RPNConfig(layer_nums=(1, 1), ds_strides=(1, 2), ds_filters=(32, 64),
                    us_strides=(1, 2), us_filters=(64, 64), in_channels=64)
    head = dataclasses.replace(cfg.model.head, in_channels=128,
                               share_conv_channel=32)
    model = dataclasses.replace(
        cfg.model, rpn=rpn, head=head, middle_channels=(8, 16, 16, 32),
        # explicit capacities, growth rule OFF: test configs must be
        # capacity-safe by construction (middle_vmax honored exactly)
        middle_vmax=(512, 256, 128, 64), middle_growth=None)
    return cfg.replace(
        model=model, voxel=voxel,
        test=TestConfig(post_center_limit_range=(-10., -10., -10., 10., 10., 10.),
                        nms=NMSConfig(pre_max_size=128, post_max_size=32)),
        assigner=dataclasses.replace(cfg.assigner,
                                     out_size_factor=1 if pp else 8,
                                     max_objs=16))

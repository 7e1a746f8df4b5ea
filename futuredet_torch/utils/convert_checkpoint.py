"""Weight bridge: flax variables <-> the port's `state_dict`.

The port's modules are named so that their `state_dict()` keys ARE the
reference det3d keys: a reference pillar `.pth` loads with
`model.load_state_dict(load_reference_state_dict(path))`, and weights made
by the JAX package come across with `flax_to_state_dict`. A reference
VoxelNet `.pth` loads once its `backbone.extra_conv.*` keys are folded into
the port's `z_crush.*` (`_compose_extra_conv`).

`_key_map` is the port's own copy of
`futuredet_tpu/utils/convert_checkpoint.py::_key_map` for the ported
modules (pillar reader, sparse middle encoder, neck, head with its
`bev_conv`), plus the `middle="dense"` detector's `voxel_embed` and
`mid_conv{0,1}.{0,1}` (the JAX `_dense_path`'s modules, which the JAX
converter does not map), plus the port-only `z_crush.{0,1}` keys of VoxelNet's z_crush
ConvBNReLU and the DCN head's keys (the reference DCNSepHead's:
`feature_adapt_{cls,reg}.{conv_offset,conv_adaption}`, `cls_head.{0,1,3}`,
`task_head.<branch>`), which the JAX converter does not map, and the
two-stage head's `two_stage_{forecast,reverse}_conv.{0,1}` (the JAX
converter maps them onto `forecast_conv.0/.1` and `reverse_conv.0/.1`,
where forecast_feature's first conv also lands). A two-stage model's keys
are these under `first_stage.`, and `roi_head.*`. The widened vel and the
multitask heads change shapes only. `flax_to_state_dict`
inverts the layout converters:

  flax Dense kernel (in, out)              -> torch Linear (out, in)
  flax Conv kernel (kh, kw, in, out)       -> torch Conv2d (out, in, kh, kw)
  flax ConvTranspose kernel (kh, kw, in, out), taps flipped
                                           -> torch ConvTranspose2d
                                              (in, out, kh, kw)
  SparseConv kernel (27, in, out), K = (kd*3+kh)*3+kw
                                           -> spconv (kd, kh, kw, in, out)
  FeatureAdaption adapt_kernel (9, in, out), K = ky*3+kx
                                           -> DeformConv2d (out, in, ky, kx)
  BN scale/bias (params), mean/var (batch_stats)
                                           -> weight/bias, running_mean/var
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig


def load_reference_state_dict(path: str,
                              cfg: Optional[ExperimentConfig] = None
                              ) -> Dict[str, torch.Tensor]:
    """torch.load a reference checkpoint -> {key: tensor} on the CPU, with the
    DDP `module.` prefix removed. A two-stage `cfg` raises: the reference's
    two-stage key layout is not mapped."""
    if cfg is not None and cfg.model.two_stage_refine:
        raise NotImplementedError(
            "a reference two-stage .pth is not mapped onto the port's "
            "first_stage. / roi_head. keys yet (ROADMAP.md, queue 1: long "
            "tail); graft a single-stage checkpoint with "
            "models/two_stage.py::adopt_first_stage")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k.removeprefix("module."): v for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# key map: list of (flax_path, ref_key, kind)
# ---------------------------------------------------------------------------

def _bn(ours_prefix: Tuple[str, ...], ref_prefix: str, bn_name: str = None):
    p = ours_prefix if bn_name is None else ours_prefix + (bn_name,)
    return ([(p + ("scale",), f"{ref_prefix}.weight", "copy"),
             (p + ("bias",), f"{ref_prefix}.bias", "copy")],
            [(p + ("mean",), f"{ref_prefix}.running_mean", "copy"),
             (p + ("var",), f"{ref_prefix}.running_var", "copy")])


def _conv_bn_relu(ours: Tuple[str, ...], ref_conv: str, ref_bn: str,
                  bias: bool):
    params = [(ours + ("Conv_0", "kernel"), f"{ref_conv}.weight", "conv")]
    if bias:
        params.append((ours + ("Conv_0", "bias"), f"{ref_conv}.bias", "copy"))
    bp, bs = _bn(ours, ref_bn, "BatchNorm_0")
    return params + bp, bs


def _key_map(cfg: ExperimentConfig):
    """(param_entries, stat_entries) of the pillar or sparse VoxelNet
    detector."""
    m = cfg.model
    params: List = []
    stats: List = []

    def add(p, s):
        params.extend(p)
        stats.extend(s)

    # reader (ref pillar_encoder.py:59-105); mean_vfe has no parameters
    if m.reader == "pillar_feature_net":
        for i in range(len(m.pillar_filters)):
            params.append((("reader", f"Dense_{i}", "kernel"),
                           f"reader.pfn_layers.{i}.linear.weight", "linear"))
            add(*_bn(("reader", f"MaskedBatchNorm_{i}"),
                     f"reader.pfn_layers.{i}.norm"))

    if m.detector == "voxelnet" and m.middle == "dense":
        # the JAX _dense_path's own modules (detector.py:260-272)
        params += [(("voxel_embed", "kernel"), "voxel_embed.weight", "linear"),
                   (("voxel_embed", "bias"), "voxel_embed.bias", "copy")]
        for i in range(2):
            add(*_conv_bn_relu((f"mid_conv{i}",), f"mid_conv{i}.0",
                               f"mid_conv{i}.1", bias=False))
    elif m.detector == "voxelnet":
        # ref SpMiddleResNetFHD (scn.py:98-146); a dense stage
        # (middle_dense_from_stage) keeps its sparse parameters and names
        params.append((("middle", "conv_input", "kernel"),
                       "backbone.conv_input.0.weight", "subm"))
        add(*_bn(("middle", "bn_input"), "backbone.conv_input.1"))

        def res_block(ours: str, ref: str):
            for cn, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                params.append((("middle", ours, cn, "kernel"),
                               f"{ref}.{cn}.weight", "subm"))
                params.append((("middle", ours, cn, "bias"),
                               f"{ref}.{cn}.bias", "copy"))
                add(*_bn(("middle", ours, bn), f"{ref}.{bn}"))

        for j in range(2):
            res_block(f"res0_{j}", f"backbone.conv1.{j}")
        for s in range(1, 4):
            params.append((("middle", f"down{s}", "kernel"),
                           f"backbone.conv{s + 1}.0.weight", "subm"))
            add(*_bn(("middle", f"bn_down{s}"), f"backbone.conv{s + 1}.1"))
            for j in range(2):
                res_block(f"res{s}_{j}", f"backbone.conv{s + 1}.{3 + j}")
        # port-only keys: the reference extra_conv folds into z_crush
        add(*_conv_bn_relu(("z_crush",), "z_crush.0", "z_crush.1",
                           bias=False))

    # neck (ref rpn.py:120-190)
    up_start = len(m.rpn.layer_nums) - len(m.rpn.us_strides)
    for i, n in enumerate(m.rpn.layer_nums):
        add(*_conv_bn_relu(("neck", f"block{i}_in"), f"neck.blocks.{i}.1",
                           f"neck.blocks.{i}.2", bias=False))
        for j in range(n):
            add(*_conv_bn_relu(
                ("neck", f"block{i}_conv{j}"), f"neck.blocks.{i}.{4 + 3 * j}",
                f"neck.blocks.{i}.{5 + 3 * j}", bias=False))
        k = i - up_start
        if k >= 0:
            if m.rpn.us_strides[k] > 1:
                params.append((("neck", f"deblock{k}", "ConvTranspose_0",
                                "kernel"),
                               f"neck.deblocks.{k}.0.weight", "deconv"))
                add(*_bn(("neck", f"deblock{k}"), f"neck.deblocks.{k}.1",
                         "BatchNorm_0"))
            else:
                add(*_conv_bn_relu(("neck", f"deblock{k}"),
                                   f"neck.deblocks.{k}.0",
                                   f"neck.deblocks.{k}.1", bias=False))

    # head (ref center_head.py:336-372)
    h = m.head
    add(*_conv_bn_relu(("head", "shared_conv"), "bbox_head.shared_conv.0",
                       "bbox_head.shared_conv.1", bias=True))
    if h.bev_map:
        for i in range(3):
            add(*_conv_bn_relu(("head", f"bev_conv{i}"),
                               f"bbox_head.bev_conv.{3 * i}",
                               f"bbox_head.bev_conv.{3 * i + 1}", bias=True))

    def branch(ours_t, ref_t, name, num_conv):
        # [conv(3j), bn(3j+1), relu] x (num_conv - 1), final conv
        for j in range(num_conv - 1):
            params.append((ours_t + (f"{name}_conv{j}", "kernel"),
                           f"{ref_t}.{name}.{3 * j}.weight", "conv"))
            params.append((ours_t + (f"{name}_conv{j}", "bias"),
                           f"{ref_t}.{name}.{3 * j}.bias", "copy"))
            add(*_bn(ours_t + (f"{name}_bn{j}",),
                     f"{ref_t}.{name}.{3 * j + 1}"))
        fi = 3 * (num_conv - 1)
        params.append((ours_t + (f"{name}_final", "kernel"),
                       f"{ref_t}.{name}.{fi}.weight", "conv"))
        params.append((ours_t + (f"{name}_final", "bias"),
                       f"{ref_t}.{name}.{fi}.bias", "copy"))

    for ti in range(len(h.num_classes)):
        ours_t = ("head", f"task{ti}")
        ref_t = f"bbox_head.tasks.{ti}"
        if h.dcn_head:
            # DCNSepHead (ref center_head.py:176-228)
            for fa in ("feature_adapt_cls", "feature_adapt_reg"):
                params += [
                    (ours_t + (fa, "conv_offset", "kernel"),
                     f"{ref_t}.{fa}.conv_offset.weight", "conv"),
                    (ours_t + (fa, "conv_offset", "bias"),
                     f"{ref_t}.{fa}.conv_offset.bias", "copy"),
                    (ours_t + (fa, "adapt_kernel"),
                     f"{ref_t}.{fa}.conv_adaption.weight", "deform")]
            for part, idx in (("cls_conv", 0), ("cls_final", 3)):
                params.append((ours_t + (part, "kernel"),
                               f"{ref_t}.cls_head.{idx}.weight", "conv"))
                params.append((ours_t + (part, "bias"),
                               f"{ref_t}.cls_head.{idx}.bias", "copy"))
            add(*_bn(ours_t + ("cls_bn",), f"{ref_t}.cls_head.1"))
            for name, (_ch, num_conv) in h.common_heads:
                branch(ours_t + ("task_head",), f"{ref_t}.task_head", name,
                       num_conv)
            continue
        if h.forecast_feature:
            for ci, (rc, rb) in enumerate(((0, 1), (3, 4))):
                add(*_conv_bn_relu(ours_t + (f"forecast_conv{ci}",),
                                   f"{ref_t}.forecast_conv.{rc}",
                                   f"{ref_t}.forecast_conv.{rb}", bias=True))
        if h.two_stage:
            # the port's own keys: the JAX converter's forecast_conv.0/.1
            # would collide with forecast_feature's first conv
            heads = dict(h.common_heads)
            for conv, pair in (("two_stage_forecast_conv", ("vel", "rot")),
                               ("two_stage_reverse_conv", ("rvel", "rrot"))):
                if all(k in heads for k in pair):
                    add(*_conv_bn_relu(ours_t + (conv,), f"{ref_t}.{conv}.0",
                                       f"{ref_t}.{conv}.1", bias=True))
        for name, (_ch, num_conv) in (list(h.common_heads)
                                      + [("hm", (0, h.num_hm_conv))]):
            branch(ours_t, ref_t, name, num_conv)
    return params, stats


# flax layout -> torch layout (inverse of the JAX package's converters)
_TO_TORCH = {
    "linear": lambda w: w.T,                                  # (in,out)->(out,in)
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),          # HWIO -> OIHW
    # undo the tap flip, then (kh, kw, in, out) -> (in, out, kh, kw)
    "deconv": lambda w: np.transpose(w[::-1, ::-1], (2, 3, 0, 1)),
    # (27, in, out) -> spconv (kd, kh, kw, in, out)
    "subm": lambda w: w.reshape(3, 3, 3, *w.shape[1:]),
    # DCN adapt_kernel (9, in, out), tap k = ky * 3 + kx -> (out, in, 3, 3)
    "deform": lambda w: np.transpose(w, (2, 1, 0)).reshape(
        w.shape[2], w.shape[1], 3, 3),
    "copy": lambda w: w,
}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def flax_to_state_dict(variables, cfg: ExperimentConfig
                       ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} numpy trees of the JAX
    PointPillarsDetector, VoxelNetDetector or TwoStageDetector -> a state
    dict that the port's detector takes with `load_state_dict(strict=True)`.
    Top-level modules (`reader`, `middle`, `z_crush`, `voxel_embed`,
    `mid_conv0/1`, `neck`, `head`; `first_stage`, `roi_head`) absent from the trees are left out, so the
    trees of one module alone, e.g. {'params': {'neck': ...}, ...}, give
    that module's keys. A params-only tree {'params': ...} maps to the
    parameter keys alone: gradients have the params' structure, and every
    layout converter is linear, so a gradient tree maps exactly as the
    weights do. A two-stage tree's `first_stage` maps as a single-stage
    tree under `first_stage.`, its `roi_head` Denses onto the RoI head's
    Linears."""
    if cfg.model.two_stage_refine:
        first = {t: v["first_stage"] for t, v in variables.items()
                 if "first_stage" in v}
        sd = {f"first_stage.{k}": v
              for k, v in _single_stage_to_state_dict(first, cfg).items()}
        for name, dense in variables["params"].get("roi_head", {}).items():
            sd[f"roi_head.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(dense["kernel"]).T,
                                     dtype=np.float32))
            sd[f"roi_head.{name}.bias"] = torch.from_numpy(
                np.asarray(dense["bias"], dtype=np.float32).copy())
        return sd
    return _single_stage_to_state_dict(variables, cfg)


def _single_stage_to_state_dict(variables, cfg: ExperimentConfig
                                ) -> Dict[str, torch.Tensor]:
    param_entries, stat_entries = _key_map(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for tree_name, entries in (("params", param_entries),
                               ("batch_stats", stat_entries)):
        if tree_name not in variables:
            continue
        for path, ref_key, kind in entries:
            if path[0] not in variables.get("params", {}):
                continue
            w = _TO_TORCH[kind](_leaf(variables[tree_name], path))
            sd[ref_key] = torch.from_numpy(
                np.ascontiguousarray(w, dtype=np.float32))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.removesuffix("running_mean") + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def _compose_extra_conv(sd: Dict[str, torch.Tensor], z_in: int, z_out: int
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """Fold the reference `backbone.extra_conv` ((3,1,1) stride-(2,1,1)
    conv + BN + ReLU over z, scn.py:140-146) into the port's z_crush 1x1
    ConvBNReLU of `z_in` = Z*C inputs and `z_out` outputs, as
    `futuredet_tpu/utils/convert_checkpoint.py::_compose_extra_conv` folds
    it into the flax z_crush. Returns the `z_crush.*` entries, or None when
    `sd` has no extra_conv or the shapes do not line up (the fold is exact
    only for a stage-3 depth D in {5, 6} and z_out = 2 * C).

    The port's middle flattens the z-stack z-major (channel z*C + c); the
    reference .dense() flattens C-major (c*D + d, scn.py:165-168), the
    layout the RPN weights expect: output depth d reads z in {2d, 2d+1,
    2d+2} and lands on column 2c + d."""
    w = sd.get("backbone.extra_conv.0.weight")
    if w is None:
        return None
    w = w.detach().cpu().to(torch.float32)
    kd, _, _, ci, co = w.shape                      # (3, 1, 1, C, C)
    D = z_in // ci
    if z_in % ci or z_out != 2 * co or D not in (5, 6):
        return None
    new = torch.zeros(z_out, z_in, 1, 1)
    for d_out in range(2):
        for kdi in range(kd):
            z = 2 * d_out + kdi
            if z < D:
                new[d_out::2, z * ci:(z + 1) * ci, 0, 0] += w[kdi, 0, 0].T
    bn = "backbone.extra_conv.1"
    out = {"z_crush.0.weight": new}
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"z_crush.1.{name}"] = torch.repeat_interleave(
            sd[f"{bn}.{name}"].detach().cpu().to(torch.float32), 2)
    out["z_crush.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out

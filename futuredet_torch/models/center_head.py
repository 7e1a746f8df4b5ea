"""CenterHead in every single-stage mode.

Port of `futuredet_tpu/models/center_head.py` (reference
`det3d/models/bbox_heads/center_head.py:40-390`): shared_conv (3x3 + BN +
ReLU), with `bev_map` the ego map's three ConvBNReLU added to it, then one
SepHead per task. The tasks and their branch widths follow the mode
(`CenterHead.task_heads`): standard and reverse heads widen vel / rvel by
`timesteps`; dense has one single-class head per future timestep (with
`forecast_feature`, head i > 0 reads concat(shared features, head i-1's
forecast features)); sparse a forward and a reverse head; classify one
3-class head per timestep; wide one 7-class head on a 512-channel share;
multitask one head per class group. `dcn_head` replaces each SepHead by a
DCNSepHead (deformable feature adaption, `ops/deform.py`). `two_stage`
(the first stage of `models/two_stage.py`) gives each SepHead a shared
ConvBNReLU that vel and rot read (`two_stage_forecast_conv`), and one that
rvel and rrot read (`two_stage_reverse_conv`) when those heads exist.

Each SepHead branch is its own conv tower, as in the reference. The JAX
package fuses branches into one wide conv on the TPU; that is a TPU
formulation over the same parameters and is not ported. Under
`compute_dtype` the two differ: the fused towers normalise in bf16
(`futuredet_tpu/models/center_head.py:194-220`), where every tower here
normalises in fp32 as flax's BatchNorm does, as the JAX per-branch
towers (`SepHead(fuse_branches=False)`) do. In training the fused
towers' backward on XLA:CPU sums each channel's cotangent over the batch
in bf16, which saturates (`tests/test_torch_bf16_grads.py`); the port's
towers are held to the JAX per-branch towers
(`tests/test_torch_train_bf16_pillars.py`). Convs run NCHW;
`CenterHead.forward` returns dicts of NHWC maps, the JAX layout.

`compute_dtype` (bf16 serving, `futuredet_tpu/models/center_head.py:
84-170`) runs shared_conv, forecast_conv and every branch tower in it,
and casts each head output back to fp32, so decode and NMS read fp32
maps; `feats` stays in it. As in the JAX head, `bev_conv`, the two-stage
shared convs and the whole DCNSepHead stay fp32, promoting their bf16
input.

Under a space layout (`models/detector.py::lay_out_space_`) every conv
runs on its rank's band of rows (`models/layers.py`). A DCNSepHead's
deformable convs sample anywhere: each gathers its input whole once
(`parallel/collectives.py::gather_rows_summed`, whose backward sums the
cotangent over the space group) and computes its band's output rows, with
offsets from the 1x1 offset conv on the band.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import HeadConfig
from ..ops.deform import deform_conv2d
from ..parallel.collectives import gather_rows_summed
from ..utils.profiling import spanned
from .layers import Conv2d, ConvBNReLU, Stack, conv_bn_relu

Heads = Tuple[Tuple[str, Tuple[int, int]], ...]


class SepHead(nn.Module):
    """Per-task head: one small conv stack per regression target. Branch
    `name` is [conv(3j), bn(3j+1), relu(3j+2)] x (num_conv-1) + final conv,
    and `forecast_conv` is [conv(0), bn(1), relu, conv(3), bn(4), relu]:
    the reference key layout. The branch convs are `head_conv` wide, or
    `in_channels` wide with `wide_head` (ref center_head.py:92). With
    `two_stage`, vel and rot read `two_stage_forecast_conv`, rvel and rrot
    `two_stage_reverse_conv` (ConvBNReLU, `head_conv` wide, ref :102-117,
    163-170), where both heads of the pair exist.

    The JAX reference converter maps `two_stage_forecast_conv` onto the
    reference's `forecast_conv.0/.1`, where forecast_feature's first conv
    also lands; the port keeps its own name, so the two never share a
    key."""

    def __init__(self, in_channels: int, heads: Heads, head_conv: int = 64,
                 final_kernel: int = 3, init_bias: float = -2.19,
                 forecast_feature: bool = False, wide_head: bool = False,
                 two_stage: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        cd = dict(compute_dtype=compute_dtype)
        self.head_names = [h for h, _ in heads]
        self.forecast_feature = forecast_feature
        self.init_bias = init_bias
        branch_conv = in_channels if wide_head else head_conv
        cin = in_channels
        if forecast_feature:
            self.forecast_conv = Stack(
                *conv_bn_relu(cin, head_conv, 3, 1, bias=True, **cd),
                *conv_bn_relu(head_conv, head_conv, 3, 1, bias=True, **cd))
            cin = head_conv
        # branch -> the shared two-stage conv it reads (ref :102-117)
        self.src_of: Dict[str, str] = {}
        for conv_name, pair in (("two_stage_forecast_conv", ("vel", "rot")),
                                ("two_stage_reverse_conv", ("rvel", "rrot"))):
            if two_stage and all(h in self.head_names for h in pair):
                self.add_module(conv_name, ConvBNReLU(cin, head_conv, 3, 1,
                                                      bias=True))
                self.src_of.update(dict.fromkeys(pair, conv_name))
        p = (final_kernel - 1) // 2
        for name, (classes, num_conv) in heads:
            layers = []
            c = head_conv if name in self.src_of else cin
            for _ in range(num_conv - 1):
                layers += conv_bn_relu(c, branch_conv, final_kernel, 1,
                                       bias=True, **cd)
                c = branch_conv
            layers.append(Conv2d(c, classes, final_kernel, padding=p, **cd))
            self.add_module(name, Stack(*layers))

    @torch.no_grad()
    def reset_init(self) -> None:
        """The heatmap's final bias at init_bias (ref :159)."""
        if "hm" in self.head_names:
            self.hm[-1].bias.fill_(self.init_bias)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.forecast_feature:
            x = self.forecast_conv(x)
            out["feats"] = x
        srcs = {conv: getattr(self, conv)(x)
                for conv in dict.fromkeys(self.src_of.values())}
        for name in self.head_names:
            inp = srcs[self.src_of[name]] if name in self.src_of else x
            y = getattr(self, name)(inp)
            out[name] = y if self.compute_dtype is None else y.float()
        return out


class DeformConv2d(Conv2d):
    """A 3x3 deformable conv without bias (ref DeformConv): Conv2d's
    weight (Cout, Cin, 3, 3) and key, `forward(x, offsets)`."""

    def __init__(self, cin: int, cout: int, deformable_groups: int):
        super().__init__(cin, cout, 3, padding=1, bias=False)
        self.deformable_groups = deformable_groups

    def forward(self, x: torch.Tensor, offsets: torch.Tensor,
                row0: int = 0) -> torch.Tensor:
        """x the whole input, offsets those of the output rows from
        `row0` (`ops/deform.py::deform_conv2d`)."""
        return deform_conv2d(x, offsets, self.weight, self.deformable_groups,
                             row0)


class FeatureAdaption(nn.Module):
    """DCN v1 feature adaption (ref center_head.py:40-79): a zero-init 1x1
    conv predicts each tap's (dy, dx) for a 3x3 deformable conv, then ReLU.
    """

    def __init__(self, cin: int, cout: int, deformable_groups: int = 4):
        super().__init__()
        self.conv_offset = Conv2d(cin, deformable_groups * 2 * 9, 1)
        self.conv_adaption = DeformConv2d(cin, cout, deformable_groups)

    @torch.no_grad()
    def reset_init(self) -> None:
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

    def forward(self, x: torch.Tensor, whole=None) -> torch.Tensor:
        """x, or under a space layout its band with `whole` = (the whole
        input, the band's first row)."""
        src, row0 = (x, 0) if whole is None else whole
        return torch.relu(self.conv_adaption(src, self.conv_offset(x), row0))


class DCNSepHead(nn.Module):
    """SepHead with deformable feature adaption (ref center_head.py:176-228):
    `hm` from `cls_head` ([conv(0), bn(1), relu, conv(3)]) on the cls
    adaption, every other branch from `task_head`, a SepHead on the
    regression adaption."""

    def __init__(self, in_channels: int, heads: Heads, num_cls: int,
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19):
        super().__init__()
        self.init_bias = init_bias
        self.feature_adapt_cls = FeatureAdaption(in_channels, in_channels)
        self.feature_adapt_reg = FeatureAdaption(in_channels, in_channels)
        self.cls_head = Stack(
            *conv_bn_relu(in_channels, head_conv, 3, 1, bias=True),
            Conv2d(head_conv, num_cls, 3, padding=1))
        self.task_head = SepHead(in_channels, heads, head_conv=head_conv,
                                 final_kernel=final_kernel,
                                 init_bias=init_bias)

    @torch.no_grad()
    def reset_init(self) -> None:
        self.cls_head[-1].bias.fill_(self.init_bias)
        self.feature_adapt_cls.reset_init()
        self.feature_adapt_reg.reset_init()

    def forward(self, x: torch.Tensor, bands=None) -> Dict[str, torch.Tensor]:
        """x (B, C, H, W), or under a space layout its rank's band, with
        `bands` every rank's rows of the whole canvas."""
        # fp32 under compute_dtype too, as the JAX DCNSepHead
        x = x.to(self.cls_head[0].weight.dtype)
        whole = None
        space = self.feature_adapt_cls.conv_adaption.space
        if self.feature_adapt_cls.conv_adaption.banded:
            # both adaptions read the whole input: one gather for the two
            whole = (gather_rows_summed(x, 2, bands, space),
                     bands[space.index][0])
        out = self.task_head(self.feature_adapt_reg(x, whole))
        out["hm"] = self.cls_head(self.feature_adapt_cls(x, whole))
        return out


class CenterHead(nn.Module):
    def __init__(self, cfg: HeadConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.dcn_head and cfg.forecast_feature:
            raise ValueError("dcn_head gives no forecast features: it takes "
                             "forecast_feature=False")
        self.cfg = cfg
        share = cfg.effective_share_channel
        self.shared_conv = ConvBNReLU(cfg.in_channels, share, 3, 1,
                                      bias=True, compute_dtype=compute_dtype)
        if cfg.bev_map:
            # ref :338-343: 1 -> 16 -> 32 -> share on the (B, H, W, 1) map
            self.bev_conv = Stack(
                *conv_bn_relu(1, 16, 3, 1, bias=True),
                *conv_bn_relu(16, 32, 3, 1, bias=True),
                *conv_bn_relu(32, share, 3, 1, bias=True))
        tasks = []
        for i, heads in enumerate(self.task_heads(cfg)):
            in_ch = 2 * share if (i != 0 and cfg.forecast_feature) else share
            if cfg.dcn_head:
                tasks.append(DCNSepHead(
                    in_ch, tuple(h for h in heads if h[0] != "hm"),
                    cfg.num_classes[i], head_conv=share,
                    init_bias=cfg.init_bias))
            else:
                tasks.append(SepHead(
                    in_ch, heads, head_conv=share, init_bias=cfg.init_bias,
                    forecast_feature=cfg.forecast_feature,
                    wide_head=cfg.wide_head, two_stage=cfg.two_stage,
                    compute_dtype=compute_dtype))
        self.tasks = nn.ModuleList(tasks)

    @staticmethod
    def task_heads(cfg: HeadConfig) -> List[Heads]:
        """Per-task branch specs (`futuredet_tpu/models/center_head.py::
        CenterHead._task_heads`, ref :351-359): vel / rvel widened by
        `timesteps` unless dense, classify or wide; hm as wide as the task's
        classes."""
        widen = not (cfg.dense or cfg.classify or cfg.wide_head)
        specs = []
        for num_cls in cfg.num_classes:
            heads = tuple(
                (name, (ch * cfg.timesteps if widen and name in ("vel", "rvel")
                        else ch, nconv))
                for name, (ch, nconv) in cfg.common_heads)
            specs.append(heads + (("hm", (num_cls, cfg.num_hm_conv)),))
        return specs

    def reset_init(self) -> None:
        """The non-default inits after `init_weights_`: each heatmap's final
        bias at init_bias, the DCN offset convs at zero."""
        for t in self.tasks:
            t.reset_init()

    @spanned("head")
    def forward(self, x: torch.Tensor, bev_map: Optional[torch.Tensor] = None,
                bands=None) -> List[Dict[str, torch.Tensor]]:
        """x (B, C, H, W), bev_map (B, H, W, 1) in canvas orientation (row =
        y bin) when the config has one -> per task a dict of (B, H, W, c)
        maps. Under a space layout x and bev_map are this rank's band of
        rows, `bands` every rank's (`SpaceGroup.bands`), and so are the
        maps."""
        x = self.shared_conv(x)
        if self.cfg.bev_map:
            if bev_map is None:
                raise ValueError("this head is bev_map-conditioned: pass "
                                 "the (B, H, W, 1) ego map")
            # fp32 (the JAX bev_conv has no compute_dtype): the sum
            # promotes a bf16 x to fp32
            x = x + self.bev_conv(bev_map.permute(0, 3, 1, 2))
        rets: List[Dict[str, torch.Tensor]] = []
        for i, task in enumerate(self.tasks):
            inp = x
            if i != 0 and self.cfg.forecast_feature:
                inp = torch.cat([x, rets[i - 1]["feats"]], dim=1)
            rets.append(task(inp, bands) if self.cfg.dcn_head
                        else task(inp))
        return [{k: v.permute(0, 2, 3, 1) for k, v in r.items()}
                for r in rets]

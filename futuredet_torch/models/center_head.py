"""CenterHead in dense + forecast_feature mode.

Port of `futuredet_tpu/models/center_head.py` (reference
`det3d/models/bbox_heads/center_head.py:81-390`): shared_conv (3x3+BN+ReLU),
then one SepHead per task. In dense mode there is one SepHead per future
timestep; with forecast_feature head i>0 reads concat(shared features,
head i-1's forecast features).

Each SepHead branch is its own conv tower, as in the reference. The JAX
package fuses branches into one wide conv on the TPU; that is a TPU
formulation over the same parameters and is not ported. Convs run NCHW;
`CenterHead.forward` returns dicts of NHWC maps, the JAX layout.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..config import HeadConfig
from .layers import ConvBNReLU, conv_bn_relu


class SepHead(nn.Module):
    """Per-task head: one small conv stack per regression target. Branch
    `name` is [conv(3j), bn(3j+1), relu(3j+2)] x (num_conv-1) + final conv,
    and `forecast_conv` is [conv(0), bn(1), relu, conv(3), bn(4), relu]:
    the reference key layout."""

    def __init__(self, in_channels: int,
                 heads: Tuple[Tuple[str, Tuple[int, int]], ...],
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19, forecast_feature: bool = False):
        super().__init__()
        self.head_names = [h for h, _ in heads]
        self.forecast_feature = forecast_feature
        self.init_bias = init_bias
        cin = in_channels
        if forecast_feature:
            self.forecast_conv = nn.Sequential(
                *conv_bn_relu(cin, head_conv, 3, 1, bias=True),
                *conv_bn_relu(head_conv, head_conv, 3, 1, bias=True))
            cin = head_conv
        p = (final_kernel - 1) // 2
        for name, (classes, num_conv) in heads:
            layers = []
            c = cin
            for _ in range(num_conv - 1):
                layers += conv_bn_relu(c, head_conv, final_kernel, 1,
                                       bias=True)
                c = head_conv
            layers.append(nn.Conv2d(c, classes, final_kernel, padding=p))
            self.add_module(name, nn.Sequential(*layers))
        self.reset_hm_bias()

    @torch.no_grad()
    def reset_hm_bias(self) -> None:
        if "hm" in self.head_names:
            self.hm[-1].bias.fill_(self.init_bias)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.forecast_feature:
            x = self.forecast_conv(x)
            out["feats"] = x
        for name in self.head_names:
            out[name] = getattr(self, name)(x)
        return out


class CenterHead(nn.Module):
    def __init__(self, cfg: HeadConfig):
        super().__init__()
        for flag in ("bev_map", "two_stage", "dcn_head"):
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"CenterHead {flag} mode is not ported yet (ROADMAP.md, "
                    "queue 1: other head modes)")
        if not cfg.dense:
            raise NotImplementedError(
                "only the dense forecast head is ported yet (ROADMAP.md, "
                "queue 1: other head modes)")
        self.cfg = cfg
        share = cfg.share_conv_channel
        self.shared_conv = ConvBNReLU(cfg.in_channels, share, 3, 1,
                                      bias=True)
        # dense: one single-class head per timestep (ref :321-334)
        heads = tuple(cfg.common_heads) + (("hm", (1, cfg.num_hm_conv)),)
        tasks = []
        for i in range(cfg.timesteps):
            in_ch = 2 * share if (i != 0 and cfg.forecast_feature) else share
            tasks.append(SepHead(in_ch, heads, head_conv=share,
                                 final_kernel=3, init_bias=cfg.init_bias,
                                 forecast_feature=cfg.forecast_feature))
        self.tasks = nn.ModuleList(tasks)

    def reset_hm_bias(self) -> None:
        for t in self.tasks:
            t.reset_hm_bias()

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x (B, C, H, W) -> per task a dict of (B, H, W, c) maps."""
        x = self.shared_conv(x)
        rets: List[Dict[str, torch.Tensor]] = []
        for i, task in enumerate(self.tasks):
            inp = x
            if i != 0 and self.cfg.forecast_feature:
                inp = torch.cat([x, rets[i - 1]["feats"]], dim=1)
            rets.append(task(inp))
        return [{k: v.permute(0, 2, 3, 1) for k, v in r.items()}
                for r in rets]

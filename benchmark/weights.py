"""The benchmark's weights: one state dict, made on the device from the
seed, loaded into the program and into the reference alike.

Every conv, transposed conv, linear and sparse conv weight is LeCun
normal (std 1 / sqrt(fan_in)), drawn in one call, but the dim branch's
last conv at a quarter of that (`DIM_SCALE`); biases are zero but each
heatmap's last bias, which is the config's `init_bias` (the port's
`init_weights_` and `reset_init`); BatchNorms are the identity. For a
served cell `calibrate_` then sets every BatchNorm's running statistics
to those of its input on one scene of the pool, through the reference,
so that an untrained network in eval mode keeps its activations near
unit scale, as a trained one's BatchNorms do.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .reference import nets

# the box sizes are exp of the dim branch: at LeCun scale its last conv
# gives outliers of 1e6 m, which no trained head gives and which fp32 box
# geometry cannot resolve; a quarter of that scale keeps sizes at metres
DIM_SCALE = 0.25
VAR_FLOOR = 0.1
_WEIGHTED = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nets.SparseConv)


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nets.SparseConv):            # (3, 3, 3, Cin, Cout)
        return 27 * m.cin
    if isinstance(m, nn.ConvTranspose2d):         # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])


@torch.no_grad()
def make_state_dict(ref: nn.Module, experiment: Dict, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """The state dict of `ref`'s architecture drawn from `seed` on
    `device` (`ref` itself is left as it is: only its shapes are read)."""
    sd = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
          for k, v in ref.state_dict().items()}
    for name, m in ref.named_modules():
        if isinstance(m, (nets.BatchNorm2d, nets.MaskedBatchNorm)):
            sd[f"{name}.weight"].fill_(1.0)
            sd[f"{name}.running_var"].fill_(1.0)
    layers = [(n, m) for n, m in ref.named_modules()
              if isinstance(m, _WEIGHTED)]
    total = sum(m.weight.numel() for _, m in layers)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    at = 0
    for name, m in layers:
        n = m.weight.numel()
        sd[f"{name}.weight"] = (flat[at:at + n].view(m.weight.shape)
                                / math.sqrt(_fan_in(m)))
        at += n
    bias = experiment["model"]["head"]["init_bias"]
    for name, m in ref.named_modules():
        if name.endswith(".hm"):
            sd[f"{name}.{len(m) - 1}.bias"].fill_(bias)
        if name.endswith(".dim"):
            sd[f"{name}.{len(m) - 1}.weight"].mul_(DIM_SCALE)
    return sd


@torch.no_grad()
def calibrate_(ref: nn.Module, state_dict: Dict[str, torch.Tensor],
               points: torch.Tensor, valid: torch.Tensor) -> None:
    """Load `state_dict` into `ref` (eval), run one scene, setting each
    BatchNorm's running mean and (biased) variance to those of its input
    at its first call (each channel's variance at least `VAR_FLOOR` of the
    layer's mean), then write them back into `state_dict`."""
    ref.load_state_dict(state_dict)
    ref.eval()
    done = set()

    def pre(module, args):
        if module in done:
            return
        done.add(module)
        x = args[0]
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        module.running_mean.copy_(mean)
        # a channel nearly constant on this scene would scale another
        # scene's values up without bound: no variance under a tenth of
        # the layer's mean
        module.running_var.copy_(torch.clamp_min(var, VAR_FLOOR
                                                 * float(var.mean())))

    hooks = [m.register_forward_pre_hook(pre) for m in ref.modules()
             if isinstance(m, (nets.BatchNorm2d, nets.MaskedBatchNorm))]
    try:
        ref(points[None], valid[None])
    finally:
        for h in hooks:
            h.remove()
    for k, v in ref.state_dict().items():
        state_dict[k].copy_(v)

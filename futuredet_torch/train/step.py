"""The single-device train step: targets, forward, loss, backward, clip and
AdamW update.

Port of the single-device path of `futuredet_tpu/train/step.py:49-175`
(reference trainer loop `det3d/torchie/trainer/trainer.py:406-463`).
Optimizer parity with `make_optimizer` there (optax): AdamW with decoupled
weight decay 0.01 on every parameter (optax.adamw decays with no mask),
eps 1e-8, b2 0.999; the learning rate and b1 follow the one-cycle schedule
at the count of updates done so far (0 for the first update), as optax's
`inject_hyperparams` evaluates them; gradients are clipped to a global
norm of 35 as optax.clip_by_global_norm clips them. Data parallelism, the
`space` axis and the two-stage freeze are not ported yet (ROADMAP.md,
queue 1).

A first AdamW step moves every parameter by about lr * sign(g), so two
runs whose gradients differ by rounding can move a parameter with a
near-zero gradient 2 * lr apart: compare gradients, or the updates of the
same gradients, never parameters after a step.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..config import ExperimentConfig
from ..data.targets import build_targets_batch
from ..models.losses import center_head_loss
from .schedule import one_cycle_lr, one_cycle_momentum

ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def make_optimizer(cfg: ExperimentConfig, model: nn.Module,
                   total_steps: int) -> torch.optim.AdamW:
    """AdamW over every parameter of `model`; each parameter group keeps
    `total_steps`, the length of the one-cycle schedule."""
    o = cfg.train.optim
    opt = torch.optim.AdamW(model.parameters(), lr=o.lr_max / o.div_factor,
                            betas=(o.moms[0], ADAM_B2), eps=ADAM_EPS,
                            weight_decay=o.weight_decay)
    for group in opt.param_groups:
        group["total_steps"] = total_steps
    return opt


def set_hyperparams(cfg: ExperimentConfig, optimizer: torch.optim.Optimizer,
                    count: int) -> None:
    """lr and b1 of every group at `count` updates done."""
    o = cfg.train.optim
    for group in optimizer.param_groups:
        total = group["total_steps"]
        group["lr"] = one_cycle_lr(count, total_steps=total,
                                   lr_max=o.lr_max, div_factor=o.div_factor,
                                   pct_start=o.pct_start)
        group["betas"] = (one_cycle_momentum(count, total_steps=total,
                                             moms=o.moms,
                                             pct_start=o.pct_start), ADAM_B2)


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """In place: g unchanged when the global norm is below max_norm, else
    g / norm * max_norm (optax.clip_by_global_norm). Returns the norm
    before clipping, on the device (no host sync)."""
    # foreach ops: a few launches for all tensors (433 at full width), not
    # a few per tensor
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    # g / 1 * 1 is g exactly
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


def forward_backward(model: nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    """Targets from batch["targets_raw"] on the device, the forward in the
    model's mode (with batch["bev_map"] for a bev_map config), the head
    mode's loss and its backward into `.grad`. Returns the losses."""
    cfg = model.cfg
    targets = build_targets_batch(cfg, batch["targets_raw"])
    preds = model(batch["points"], batch["points_valid"],
                  batch.get("bev_map"))
    losses = center_head_loss(cfg.model.head, preds, targets)
    losses["loss"].backward()
    return losses


def apply_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                 count: int) -> torch.Tensor:
    """Clip the gradients in `.grad` and take the AdamW step of update
    `count`. Returns the global gradient norm before clipping."""
    cfg = model.cfg
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = clip_by_global_norm(grads, cfg.train.optim.grad_clip_norm)
    set_hyperparams(cfg, optimizer, count)
    optimizer.step()
    return norm


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict, step: int) -> Dict[str, torch.Tensor]:
    """One update of a model in train mode on a batch on its device
    ({"points", "points_valid", "targets_raw"}, and "bev_map" for a
    bev_map config). `step` is the count of
    updates done before this one. Returns {loss, hm_loss, loc_loss,
    grad_norm} as tensors on the device."""
    if not model.training:
        raise ValueError("train_step needs the model in train mode "
                         "(model.train()): eval BatchNorm would not learn "
                         "its statistics")
    optimizer.zero_grad(set_to_none=True)
    losses = forward_backward(model, batch)
    grad_norm = apply_update(model, optimizer, step)
    return {"loss": losses["loss"].detach(),
            "hm_loss": losses["hm_loss"].detach(),
            "loc_loss": losses["loc_loss"].detach(), "grad_norm": grad_norm}

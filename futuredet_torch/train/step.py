"""The single-device train step: targets, forward, loss, backward, clip and
AdamW update.

Port of the single-device path of `futuredet_tpu/train/step.py:49-175`
(reference trainer loop `det3d/torchie/trainer/trainer.py:406-463`).
Optimizer parity with `make_optimizer` there (optax): AdamW with decoupled
weight decay 0.01 on every parameter (optax.adamw decays with no mask),
eps 1e-8, b2 0.999; the learning rate and b1 follow the one-cycle schedule
at the count of updates done so far (0 for the first update), as optax's
`inject_hyperparams` evaluates them; gradients are clipped to a global
norm of 35 as optax.clip_by_global_norm clips them.

Data parallelism (the JAX step under `shard_map` over its `data` axis,
`futuredet_tpu/train/step.py:139-160`): in a `torch.distributed` process
group each rank runs this step on its own batch; the BatchNorms average
their statistics over the ranks inside the forward (`parallel/
collectives.py::pmean`, with gradient), the gradients are averaged in one
all-reduce before the clip (`average_gradients_`), and the losses that the
step returns are rank means, as the JAX `pmean`s of grads and losses. The
same gradients on every rank give the same update, and the averaged
statistics the same running statistics.

Spatial sharding (`--space`, the JAX `_make_train_step_gspmd`,
`futuredet_tpu/train/step.py:179-233`): a model built with a
`parallel/mesh.py::SpaceGroup` holds a band of the canvas on each rank of
a space group, which all read the same batch. The step's semantics are
the GSPMD step's, global: the BatchNorms take the global batch's
statistics (`models/layers.py`, `models/readers.py`), and the loss is
normalised per sample, then averaged over the batch, as the JAX step's
`jax.vmap` of `center_head_loss` (`:197-206`; at a batch of one this is
`forward_backward`'s loss). Every rank computes that loss on the
gathered head maps, its backward reaches only its band, so the gradient
is the sum over the space group and the mean over the data group
(`average_gradients_`). The clip, AdamW, `grad_norm` and the rank-mean
losses are those of the data-parallel step.

Under a space layout a two-stage model adds the RoI head's loss over the
batch to the per-sample head loss, as the GSPMD step does (`:208-226`):
every rank runs the RoI stage whole on the gathered maps, so the RoI
head's gradients are whole on every rank and are averaged over the space
group, not summed (`models/detector.py::whole_parameters`).

A two-stage model (`models/two_stage.py`) adds the RoI head's loss and
trains only `two_stage_trainable_mask`'s parameters, as the JAX
package's `multi_transform` (train: clip + AdamW, freeze: `set_to_zero`,
step.py:63-74) does: the optimizer holds only those, the clip's norm is
theirs, frozen parameters get no update and no weight decay. The whole
backward still runs, the `grad_norm` metric is over every gradient
(`optax.global_norm(grads)`), and frozen BatchNorms update their running
statistics, the model being in train mode as a whole.

Under a bf16 knob (`compute_dtype`, `middle_sparse_dtype="bfloat16"`,
`middle_dense_dtype`) the forward runs those parts in bf16 and their
backward follows the JAX package's dtypes (`models/layers.py`,
`ops/sparse_conv.py::SparseConvFunction`, `models/middle.py::
SparseConv.dense`); the head's outputs, the loss, the gradients (fp32
parameters) and the clip stay fp32, and a two-stage model's RoI head
stays fp32, as in the JAX package. The knobs the JAX package makes exact
in training (`window*`, `hybrid`, `bf16_packed`) train as fp32.

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
from ..models.detector import whole_parameters
from ..models.losses import center_head_loss
from ..parallel.collectives import average_gradients_, pmean
from .schedule import one_cycle_lr, one_cycle_momentum

ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def make_optimizer(cfg: ExperimentConfig, model: nn.Module,
                   total_steps: int) -> torch.optim.AdamW:
    """AdamW over every parameter of `model`, or under the two-stage
    schedule (`head.two_stage`, as the JAX `make_optimizer` reads it) only
    over those of `two_stage_trainable_mask`; each parameter group keeps
    `total_steps`, the length of the one-cycle schedule."""
    o = cfg.train.optim
    params = list(model.parameters())
    if cfg.model.head.two_stage:
        from ..models.two_stage import two_stage_trainable_mask
        names = two_stage_trainable_mask(model)
        params = [p for n, p in model.named_parameters() if n in names]
    opt = torch.optim.AdamW(params, lr=o.lr_max / o.div_factor,
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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), on
    the device."""
    # foreach ops: a few launches for all tensors (433 at full width), not
    # a few per tensor
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """In place: g unchanged when the global norm is below max_norm, else
    g / norm * max_norm (optax.clip_by_global_norm). Returns the norm
    before clipping, on the device (no host sync)."""
    norm = global_norm(grads)
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    # g / 1 * 1 is g exactly
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


def per_sample_loss(cfg: ExperimentConfig, preds, targets
                    ) -> Dict[str, torch.Tensor]:
    """The head mode's losses of each sample alone, averaged over the
    batch (the JAX GSPMD step's `jax.vmap` of `center_head_loss`,
    futuredet_tpu/train/step.py:197-206)."""
    B = targets["hm"].shape[0]
    each = [center_head_loss(cfg.model.head,
                             [{k: v[i:i + 1] for k, v in task.items()}
                              for task in preds],
                             {k: v[i:i + 1] for k, v in targets.items()})
            for i in range(B)]
    return {k: torch.stack([e[k] for e in each]).mean(0) for k in each[0]}


def forward_backward(model: nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    """Targets from batch["targets_raw"] on the device, the forward in the
    model's mode (with batch["bev_map"] for a bev_map config), the head
    mode's loss (per sample under a space layout) plus, for a two-stage
    model, the RoI head's over the batch (roi_cls_loss and roi_reg_loss:
    JAX step.py:123-135, 208-226), and its backward into `.grad`. Returns
    the losses."""
    cfg = model.cfg
    targets = build_targets_batch(cfg, batch["targets_raw"])
    out = model(batch["points"], batch["points_valid"],
                batch.get("bev_map"))
    two_stage = cfg.model.two_stage_refine
    preds = out[0] if two_stage else out
    if getattr(model, "space", None) is not None:
        losses = per_sample_loss(cfg, preds, {
            k: v for k, v in targets.items()
            if not (two_stage and k in ("gt_boxes", "gt_valid"))})
    else:
        losses = center_head_loss(cfg.model.head, preds, targets)
    if two_stage:
        from ..models.two_stage import two_stage_loss
        _, det, roi = out
        rl = two_stage_loss(roi["logits"], roi["resid"], det.boxes,
                            targets["gt_boxes"], targets["gt_valid"],
                            det.valid)
        losses = dict(losses, roi_cls_loss=rl["roi_cls_loss"],
                      roi_reg_loss=rl["roi_reg_loss"],
                      loss=losses["loss"] + rl["loss"])
    losses["loss"].backward()
    return losses


def apply_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                 count: int) -> torch.Tensor:
    """Clip the gradients in `.grad` of the optimizer's parameters and take
    the AdamW step of update `count`. Returns the global norm of every
    gradient of `model` before clipping (the optimizer's parameters are all
    of them but for a two-stage model)."""
    cfg = model.cfg
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    trained = [p.grad for g in optimizer.param_groups for p in g["params"]
               if p.grad is not None]
    norm = None if len(trained) == len(grads) else global_norm(grads)
    clip_norm = clip_by_global_norm(trained, cfg.train.optim.grad_clip_norm)
    set_hyperparams(cfg, optimizer, count)
    optimizer.step()
    return clip_norm if norm is None else norm


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict, step: int) -> Dict[str, torch.Tensor]:
    """One update of a model in train mode on a batch on its device
    ({"points", "points_valid", "targets_raw"}, and "bev_map" for a
    bev_map config). `step` is the count of
    updates done before this one. Returns {loss, hm_loss, loc_loss,
    grad_norm}, and roi_cls_loss and roi_reg_loss for a two-stage model,
    as tensors on the device; in a data-parallel run the losses are the
    means over the ranks and the gradients those averaged over them
    (summed over a space group's bands)."""
    if not model.training:
        raise ValueError("train_step needs the model in train mode "
                         "(model.train()): eval BatchNorm would not learn "
                         "its statistics")
    # every gradient, the frozen ones too: the grad_norm metric reads them
    model.zero_grad(set_to_none=True)
    losses = forward_backward(model, batch)
    average_gradients_(list(model.parameters()),
                       getattr(model, "space", None), whole_parameters(model))
    grad_norm = apply_update(model, optimizer, step)
    keys = list(losses)
    means = pmean(*(losses[k].detach() for k in keys))
    return {**dict(zip(keys, means)), "grad_norm": grad_norm}

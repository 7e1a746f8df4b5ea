"""Two train steps of `tiny_variant(pp_forecast_n3dtf_two_stage)` at B = 2,
futuredet_torch against the JAX package's single-device train step (the
`local_step` of `futuredet_tpu/train/step.py::make_train_step`: on-device
targets, the train-mode apply of the TwoStageDetector, center_head_loss
with the two-stage weights plus two_stage_loss, value_and_grad, and its
`make_optimizer`, whose `multi_transform` trains the
`two_stage_trainable_mask` subset and sets every other update to zero),
from the same weights on the same batch:

  * the losses, roi_cls_loss and roi_reg_loss among them (1e-4 relative);
    hm_loss 0 for every task;
  * `grad_norm`, the norm of every gradient, the frozen ones included
    (1e-3 relative);
  * each trainable gradient (1e-2 of its max |JAX|);
  * the running statistics of every BatchNorm, frozen ones included (1e-4);
  * both optimizers fed the JAX gradients: frozen parameters bit-identical
    to before, trainable ones updated as optax updates them (1e-6);
  * the clip's norm over the trainable subset only: with a grad_clip_norm
    that binds and scales the gradients down to AdamW's eps, the update of
    the same gradients matches optax's (1e-6), where a clip by the norm of
    every gradient would be more than 10x that far off.

Every BatchNorm bias is raised by 3 (tests/test_torch_train_step.py), the
heatmap biases are raised so that many proposals pass the score threshold,
the box-size branch is damped so that proposals have the GT's scale, and
three GT objects a sample are moved onto proposals, so that some are
foreground. The proposals' boxes carry gradient into the first stage
through the targets of two_stage_loss, as in the JAX step. One JAX
compile serves both steps; the clip case reuses the first step's
gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.models.two_stage import two_stage_loss as jax_roi_loss
from futuredet_tpu.models.two_stage import \
    two_stage_trainable_mask as jax_mask
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.two_stage import two_stage_trainable_mask
from futuredet_torch.train.step import (apply_update, forward_backward,
                                        make_optimizer)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_train_step import (  # noqa: F401 (a fixture)
    jax_variables, one_torch_thread)

NAME = "pp_forecast_n3dtf_two_stage"
TOTAL_STEPS = 20
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
GRAD_FRACTION = 1e-2
ZERO_FRACTION = 1e-6      # of the largest trainable |g|: zero up to rounding
STAT_ATOL = 1e-4
PARAM_ATOL = 1e-6
N_TRAINABLE = 92
LOSS_KEYS = ("loss", "hm_loss", "loc_loss", "roi_cls_loss", "roi_reg_loss")


def configs(clip=None):
    out = []
    for mod in (jax_config, port_config):
        cfg = mod.tiny_variant(mod.get_config(NAME))
        if clip is not None:
            o = cfg.train.optim
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, optim=dataclasses.replace(o, grad_clip_norm=clip)))
        out.append(cfg)
    return out


def step_variables(model, pts, valid):
    variables = jax_variables(model, pts, valid)
    head = variables["params"]["first_stage"]["head"]
    for t in head:
        if t.startswith("task"):
            head[t]["hm_final"]["bias"][:] = 0.0
            head[t]["dim_final"]["kernel"] *= 0.05
            head[t]["dim_final"]["bias"][:] = np.log(2.0)
    return variables


def plant_foreground(cfg, variables, batch, per_sample=3):
    """Move `per_sample` GT objects of each sample onto proposals the model
    makes in train mode (shifted 0.1 m, 5% larger, turned 0.05 rad), so
    that the RoI head has foreground proposals: with random weights the
    first stage's boxes meet no GT. Both packages then train on the same
    raw GT."""
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        _, det, _ = model.train()(batch["points"], batch["points_valid"])
    raw = batch["targets_raw"]
    for b in range(det.valid.shape[0]):
        objs = torch.nonzero(raw["gt_valid"][b, 0])[:per_sample, 0]
        props = torch.nonzero(det.valid[b])[::7, 0]
        assert len(objs) == len(props[:per_sample]) == per_sample
        for m, i in zip(objs, props):
            box = det.boxes[b, i]
            g = raw["gt_boxes"][b, 0, m]
            g[:3] = box[:3] + torch.tensor([0.1, -0.1, 0.05])
            g[3:6] = box[3:6] * 1.05
            g[10] = box[8] + 0.05


def port_snapshot(model):
    return ({n: p.detach().numpy().copy()
             for n, p in model.named_parameters()},
            {n: b.numpy().copy() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def run():
    cfg_j, cfg = configs()
    batch = make_batch(cfg, 2, seed=12, n_objects=14, n_clutter=300,
                       points_per_object=200)
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    model = jax_build(cfg_j)
    variables = step_variables(model, pts[:1], valid[:1])
    plant_foreground(cfg, variables, batch)
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}

    def loss_fn(params, batch_stats, pts, valid, raw):
        targets = jax_build_targets_batch(cfg_j, raw)
        (preds, det, roi), mut = model.apply(
            {"params": params, "batch_stats": batch_stats}, pts, valid,
            train=True, mutable=["batch_stats"])
        losses = jax_loss(cfg_j.model.head, preds, targets)
        rl = jax_roi_loss(roi["logits"], roi["resid"], det.boxes,
                          targets["gt_boxes"], targets["gt_valid"],
                          det.valid)
        losses = dict(losses, roi_cls_loss=rl["roi_cls_loss"],
                      roi_reg_loss=rl["roi_reg_loss"],
                      loss=losses["loss"] + rl["loss"])
        return losses["loss"], (losses, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    tx = jax_make_optimizer(cfg_j, TOTAL_STEPS, params)
    opt_state = tx.init(params)

    torch_model = build_detector(cfg, device="cpu")
    torch_model.load_state_dict(flax_to_state_dict(variables, cfg),
                                strict=True)
    torch_model.train()
    opt = make_optimizer(cfg, torch_model, TOTAL_STEPS)
    steps = []
    for step in range(2):
        (_, (losses, new_stats)), grads = grad_fn(
            params, stats, jnp.asarray(pts), jnp.asarray(valid),
            jax.tree.map(jnp.asarray, raw))
        grads = jax.device_get(grads)
        torch_model.zero_grad(set_to_none=True)
        port_losses = forward_backward(torch_model, batch)
        before = port_snapshot(torch_model)[0]
        grads_port = {n: (None if p.grad is None else p.grad.numpy().copy())
                      for n, p in torch_model.named_parameters()}
        stats_port = port_snapshot(torch_model)[1]
        # both optimizers take the JAX gradients (optax's update is eager)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = jax.device_get(optax.apply_updates(params, upd))
        stats = jax.device_get(new_stats)
        jax_sd = flax_to_state_dict({"params": grads}, cfg)
        for n, p in torch_model.named_parameters():
            p.grad = jax_sd[n].clone()
        norm = apply_update(torch_model, opt, step)
        steps.append(dict(
            jax_losses=jax.device_get(losses), jax_grads=grads,
            jax_grad_norm=float(optax.global_norm(grads)),
            jax_stats=stats,
            losses={k: v.detach().numpy() for k, v in port_losses.items()},
            grads=grads_port, stats=stats_port, before=before,
            after=port_snapshot(torch_model)[0],
            apply_norm=float(norm),
            jax_after=flax_to_state_dict({"params": params}, cfg)))
    return dict(cfg=cfg, cfg_j=cfg_j, model=torch_model, steps=steps,
                jax_mask=jax_mask(variables["params"]),
                variables=variables, grad_fn=grad_fn, batch=batch,
                grads0=steps[0]["jax_grads"])


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_losses_match_jax(run, step):
    st = run["steps"][step]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(st["losses"][k],
                                   np.asarray(st["jax_losses"][k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    assert not st["losses"]["hm_loss"].any()
    assert st["losses"]["hm_loss"].shape == (7,)
    # the RoI head's loss has both parts on this batch
    assert st["losses"]["roi_cls_loss"] > 0
    assert st["losses"]["roi_reg_loss"] > 0


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_grad_norm_is_over_every_gradient(run, step):
    st = run["steps"][step]
    np.testing.assert_allclose(st["apply_norm"], st["jax_grad_norm"],
                               rtol=1e-6)
    got = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                      for g in st["grads"].values() if g is not None))
    np.testing.assert_allclose(got, st["jax_grad_norm"],
                               rtol=GRAD_NORM_RTOL)
    # the frozen gradients are computed, the box maps' through the
    # proposals' targets among them
    mask = two_stage_trainable_mask(run["model"])
    frozen = {n for n, g in st["grads"].items()
              if n not in mask and g is not None and np.abs(g).max() > 0}
    assert len(frozen) > 200
    assert any(".dim." in n for n in frozen)


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_trainable_gradients_match_jax(run, step):
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"]}, run["cfg"])
    mask = two_stage_trainable_mask(run["model"])
    assert len(mask) == N_TRAINABLE
    top = max(float(np.abs(want[n].numpy()).max()) for n in mask)
    real = 0
    for n in sorted(mask):
        w = want[n].numpy()
        g = st["grads"][n]
        g = np.zeros_like(w) if g is None else g
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        if scale <= ZERO_FRACTION * top:
            # zero up to rounding (a conv bias under a train-mode BN)
            assert float(np.abs(g).max()) <= 2 * ZERO_FRACTION * top, n
            continue
        assert err <= GRAD_FRACTION * scale, (n, err, scale)
        real += 1
    assert real >= 60
    # the RoI head and both branches of every task have gradients
    assert all(float(np.abs(want[n].numpy()).max()) > 0 for n in mask
               if n.startswith("roi_head.") or ".vel.0." in n)


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_running_statistics_match_jax(run, step):
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"],
                               "batch_stats": st["jax_stats"]}, run["cfg"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert set(keys) == set(st["stats"])
    mask = two_stage_trainable_mask(run["model"])
    frozen_bn = [k for k in keys if k.rsplit(".", 1)[0] + ".weight"
                 not in mask]
    assert len(frozen_bn) > 0.8 * len(keys)
    for k in keys:
        np.testing.assert_allclose(st["stats"][k], want[k].numpy(),
                                   atol=STAT_ATOL, rtol=0, err_msg=k)
    # frozen layers' statistics moved from the initial ones
    init = flax_to_state_dict(run["variables"], run["cfg"])
    assert all(not np.array_equal(run["steps"][0]["stats"][k],
                                  init[k].numpy()) for k in frozen_bn)


@pytest.mark.parametrize("step", [0, 1])
def test_two_stage_update_freezes_all_but_the_mask(run, step):
    st = run["steps"][step]
    mask = two_stage_trainable_mask(run["model"])
    for n, before in st["before"].items():
        if n in mask:
            np.testing.assert_allclose(st["after"][n],
                                       st["jax_after"][n].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)
            assert not np.array_equal(st["after"][n], before), n
        else:
            np.testing.assert_array_equal(st["after"][n], before, err_msg=n)
            np.testing.assert_array_equal(st["jax_after"][n].numpy(), before,
                                          err_msg=n)


def jts_mask_of(run, path):
    """The JAX mask's value at a params path."""
    node = run["jax_mask"]
    for k in path:
        node = node[k.key]
    return bool(node)


def optax_update(run, clip, grads):
    """The JAX optimizer's first update of `grads` at grad_clip_norm
    `clip`, through the bridge."""
    cfg_j, cfg = configs(clip)
    params = run["variables"]["params"]
    tx = jax_make_optimizer(cfg_j, TOTAL_STEPS, params)
    upd, _ = tx.update(grads, tx.init(params), params)
    return cfg, flax_to_state_dict({"params": jax.device_get(
        optax.apply_updates(params, upd))}, cfg)


def test_two_stage_clip_is_over_the_trainable_gradients(run):
    """A grad_clip_norm that binds and scales the trainable gradients down
    to AdamW's eps (1e-8), where the first update depends on their scale:
    optax clips the subset by its own norm, and the port's update of the
    same gradients matches it (1e-6); a clip by the norm of every gradient
    (4x larger here) gives updates more than 10x that far off."""
    mask = two_stage_trainable_mask(run["model"])
    # the frozen gradients 10x larger: they change only the norm of every
    # gradient, which must not reach the clip
    grads = jax.tree_util.tree_map_with_path(
        lambda path, g: g if jts_mask_of(run, path) else 10 * g,
        run["grads0"])
    sd = flax_to_state_dict({"params": grads}, run["cfg"])
    sub = float(np.sqrt(sum(float(np.sum(sd[n].numpy().astype(np.float64)
                                         ** 2)) for n in mask)))
    full = float(optax.global_norm(grads))
    assert full > 4 * sub
    clip = sub * 1e-8
    cfg, want = optax_update(run, clip, grads)
    # the subset clipped by the full norm instead: a smaller scale
    wrong = optax_update(run, clip * sub / full, grads)[1]

    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(run["variables"], cfg),
                          strict=True)
    model.train()
    opt = make_optimizer(cfg, model, TOTAL_STEPS)
    for n, p in model.named_parameters():
        p.grad = sd[n].clone()
    norm = apply_update(model, opt, 0)
    np.testing.assert_allclose(float(norm), full, rtol=1e-6)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=n)
    off = max(float(np.abs(want[n].numpy() - wrong[n].numpy()).max())
              for n in mask)
    assert off > 10 * PARAM_ATOL, off

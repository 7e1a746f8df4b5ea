"""Two train steps of the small two-stage VoxelNet
(`tests/test_torch_two_stage.py::vox_config`: the zero-drop sparse
VoxelNet as forecast_n3dtf_two_stage) at B = 2, futuredet_torch against
the JAX package's single-device train step, from the same weights on the
same batch, as `tests/test_torch_train_two_stage.py` holds the pillar
two-stage step and to its tolerances:

  * the losses, roi_cls_loss and roi_reg_loss among them (1e-4 relative);
  * `grad_norm`, the norm of every gradient, the frozen ones included
    (1e-3 relative);
  * each trainable gradient (1e-2 of its max |JAX|; one near zero, up to
    rounding, only small);
  * the running statistics of every BatchNorm, the middle encoder's
    per-sample ones among them (1e-4).

The sparse middle's backward runs through K2's plain version here (the
input gradient over flipped weights and inverse tables, `SparseConvFunction`),
against the JAX custom VJPs; the RoI loss reaches the first stage through
the proposals' targets, as in the JAX step. One JAX compile serves both
steps; the port feeds the JAX gradients to both optimizers between them."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.models.two_stage import two_stage_loss as jax_roi_loss
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.two_stage import two_stage_trainable_mask
from futuredet_torch.train.step import (apply_update, forward_backward,
                                        make_optimizer)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_train_two_stage import (GRAD_FRACTION, GRAD_NORM_RTOL,
                                              LOSS_KEYS, LOSS_RTOL,
                                              N_TRAINABLE, STAT_ATOL,
                                              TOTAL_STEPS, ZERO_FRACTION,
                                              plant_foreground,
                                              step_variables)
from tests.test_torch_train_step import (  # noqa: F401 (a fixture)
    one_torch_thread)
from tests.test_torch_two_stage import vox_config


@pytest.fixture(scope="module")
def run():
    cfg_j, cfg = vox_config(jax_config), vox_config(port_config)
    batch = make_batch(cfg, 2, seed=12, n_objects=14, n_clutter=300,
                       points_per_object=100)
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
        grads_port = {n: (None if p.grad is None else p.grad.numpy().copy())
                      for n, p in torch_model.named_parameters()}
        stats_port = {n: b.numpy().copy()
                      for n, b in torch_model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}
        upd, opt_state = tx.update(grads, opt_state, params)
        params = jax.device_get(optax.apply_updates(params, upd))
        stats = jax.device_get(new_stats)
        jax_sd = flax_to_state_dict({"params": grads}, cfg)
        for n, p in torch_model.named_parameters():
            p.grad = jax_sd[n].clone()
        norm = apply_update(torch_model, opt, step)
        steps.append(dict(
            jax_losses=jax.device_get(losses), jax_grads=grads,
            jax_grad_norm=float(optax.global_norm(grads)), jax_stats=stats,
            losses={k: v.detach().numpy() for k, v in port_losses.items()},
            grads=grads_port, stats=stats_port, apply_norm=float(norm),
            voxels=list(torch_model.num_voxels)))
    return dict(cfg=cfg, model=torch_model, steps=steps)


@pytest.mark.parametrize("step", [0, 1])
def test_vox_two_stage_losses_match_jax(run, step):
    st = run["steps"][step]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(st["losses"][k],
                                   np.asarray(st["jax_losses"][k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    assert st["losses"]["roi_cls_loss"] > 0
    assert st["losses"]["roi_reg_loss"] > 0
    # both samples voxelize under the budget: the JAX step drops nothing
    assert max(st["voxels"]) < run["cfg"].voxel.max_voxels_train


@pytest.mark.parametrize("step", [0, 1])
def test_vox_two_stage_grad_norm_is_over_every_gradient(run, step):
    st = run["steps"][step]
    np.testing.assert_allclose(st["apply_norm"], st["jax_grad_norm"],
                               rtol=1e-6)
    got = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                      for g in st["grads"].values() if g is not None))
    np.testing.assert_allclose(got, st["jax_grad_norm"],
                               rtol=GRAD_NORM_RTOL)
    # the sparse middle's gradients are among the frozen ones computed
    assert any(n.startswith("first_stage.backbone.")
               and np.abs(g).max() > 0
               for n, g in st["grads"].items() if g is not None)


@pytest.mark.parametrize("step", [0, 1])
def test_vox_two_stage_trainable_gradients_match_jax(run, step):
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
        if scale <= ZERO_FRACTION * top:
            assert float(np.abs(g).max()) <= 2 * ZERO_FRACTION * top, n
            continue
        err = float(np.abs(g - w).max())
        assert err <= GRAD_FRACTION * scale, (n, err, scale)
        real += 1
    assert real >= 60


@pytest.mark.parametrize("step", [0, 1])
def test_vox_two_stage_running_statistics_match_jax(run, step):
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"],
                               "batch_stats": st["jax_stats"]}, run["cfg"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert set(keys) == set(st["stats"])
    assert any(".backbone." in k for k in keys)
    for k in keys:
        np.testing.assert_allclose(st["stats"][k], want[k].numpy(),
                                   atol=STAT_ATOL, rtol=0, err_msg=k)

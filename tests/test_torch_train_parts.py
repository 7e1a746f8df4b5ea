"""The training parts of futuredet_torch against the JAX package, on the
same numpy-seeded inputs: the synthetic scenes (bit-identical), the
gaussian targets of all three families and the multitask family (1e-6;
ind, mask and cat equal),
the dense head's loss and its gradients with respect to the predictions
(1e-5), the one-cycle schedules at every step of a 50-step run (1e-6
relative: XLA's and torch's float32 cos differ by an ulp at one step), and
clip + AdamW over 5 steps on the same gradients (1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from futuredet_tpu import config as jax_config
from futuredet_tpu.data import synthetic as jax_synth
from futuredet_tpu.data.targets import build_targets as jax_build_targets
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.train.schedule import one_cycle_lr as jax_lr
from futuredet_tpu.train.schedule import one_cycle_momentum as jax_mom
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data import synthetic
from futuredet_torch.data.targets import build_targets, build_targets_batch
from futuredet_torch.models.losses import center_head_loss
from futuredet_torch.train.schedule import one_cycle_lr, one_cycle_momentum
from futuredet_torch.train.step import apply_update, make_optimizer
from tests.test_torch_voxelnet import voxelnet_config

TARGET_ATOL = 1e-6
LOSS_TOL = 1e-5
OPT_ATOL = 1e-6


def scene_kwargs():
    return dict(n_objects=12, n_clutter=300, points_per_object=100)


@pytest.mark.parametrize("mode", ["uniform", "spread", "lidar"])
def test_synthetic_scene_is_bit_identical_to_jax(mode):
    cfg_j = voxelnet_config(jax_config)
    cfg = voxelnet_config(port_config)
    a = jax_synth.make_scene(cfg_j, seed=3, clutter_mode=mode,
                             **scene_kwargs())
    b = synthetic.make_scene(cfg, seed=3, clutter_mode=mode,
                             **scene_kwargs())
    for f in ("points", "points_valid", "gt_boxes", "gt_classes",
              "gt_valid", "traj_classes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert synthetic.SCENE_FAMILIES == jax_synth.SCENE_FAMILIES


def test_family_scene_at_full_width_is_bit_identical_to_jax():
    """The lidar family scene of chip_smoke's train phase, at full width
    (300k point budget, M = 500)."""
    a = jax_synth.make_family_scene(jax_config.get_config("forecast_n3dtf"),
                                    "lidar", n_clutter=20000, seed=5)
    b = synthetic.make_family_scene(port_config.get_config("forecast_n3dtf"),
                                    "lidar", n_clutter=20000, seed=5)
    for f in ("points", "points_valid", "gt_boxes", "traj_classes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_make_batch_holds_the_scenes():
    cfg = voxelnet_config(port_config)
    batch = synthetic.make_batch(cfg, 2, seed=4, **scene_kwargs())
    s1 = synthetic.make_scene(cfg, seed=5, **scene_kwargs())
    np.testing.assert_array_equal(batch["points"][1].numpy(), s1.points)
    raw = batch["targets_raw"]
    assert raw["gt_boxes"].shape == (2, 7, 16, 12)
    np.testing.assert_array_equal(raw["traj_classes"][1].numpy(),
                                  s1.traj_classes)


def targets_config(mod, out_size_factor):
    """The small VoxelNet config, its feature map at 8 x 8 (the test
    config's own factor 8) or 32 x 32 (factor 2)."""
    cfg = voxelnet_config(mod)
    return cfg.replace(assigner=dataclasses.replace(
        cfg.assigner, out_size_factor=out_size_factor))


@pytest.mark.parametrize("out_size_factor", [8, 2])
def test_targets_match_jax(out_size_factor):
    cfg_j = targets_config(jax_config, out_size_factor)
    cfg = targets_config(port_config, out_size_factor)
    scenes = [synthetic.make_scene(cfg, seed=s, **scene_kwargs())
              for s in (0, 1)]
    raw = {k: torch.from_numpy(np.stack([getattr(s, f) for s in scenes]))
           for k, f in (("gt_boxes", "gt_boxes"), ("gt_classes", "gt_classes"),
                        ("gt_valid", "gt_valid"),
                        ("traj_classes", "traj_classes"))}
    got = build_targets_batch(cfg, raw)
    assert set(got) >= {"hm", "hm_trajectory", "hm_forecast", "gt_boxes"}
    for b, s in enumerate(scenes):
        want = jax.device_get(jax_build_targets(
            cfg_j, s.gt_boxes, s.gt_classes, s.gt_valid, s.traj_classes))
        one = build_targets(cfg, *(torch.from_numpy(getattr(s, f)) for f in
                                   ("gt_boxes", "gt_classes", "gt_valid",
                                    "traj_classes")))
        assert set(one) == set(want)
        for k, w in want.items():
            g = got[k][b].numpy()
            assert g.shape == w.shape, (k, g.shape, w.shape)
            np.testing.assert_array_equal(one[k].numpy(), g, err_msg=k)
            if k.startswith(("hm", "anno_box")):
                np.testing.assert_allclose(g, w, atol=TARGET_ATOL, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
    # the scenes put gaussians on the maps of every family
    for k in ("hm", "hm_trajectory", "hm_forecast"):
        assert float(got[k].max()) == 1.0 and int(got["mask"].sum()) > 10


def test_multitask_targets_raise():
    """The multitask family (no longer refused) against the JAX package's:
    per class group the t = 0 objects of its classes, heatmaps padded to
    the widest group, `cat` the index within the group."""
    cfg = port_config.tiny_variant(
        port_config.get_config("centerpoint_multitask"))
    cfg_j = jax_config.tiny_variant(
        jax_config.get_config("centerpoint_multitask"))
    s = synthetic.make_scene(cfg, seed=0, **scene_kwargs())
    fields = ("gt_boxes", "gt_classes", "gt_valid", "traj_classes")
    got = build_targets(cfg, *(torch.from_numpy(getattr(s, f))
                               for f in fields))
    want = jax.device_get(jax_build_targets(cfg_j, *(getattr(s, f)
                                                     for f in fields)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   atol=TARGET_ATOL, rtol=0, err_msg=k)
    assert got["hm"].shape[0] == 6 and int(got["mask"].sum()) > 0


def random_preds(cfg, rng, B):
    """Per timestep a dict of NHWC head maps, as the dense head gives."""
    W, H = cfg.feature_map_size
    heads = dict(cfg.model.head.common_heads)
    heads["hm"] = (1, 2)
    return [{k: rng.normal(0, 1, (B, H, W, c)).astype(np.float32)
             for k, (c, _) in heads.items()} for _ in range(7)]


def test_center_head_loss_and_its_gradients_match_jax():
    cfg_j = targets_config(jax_config, 2)
    cfg = targets_config(port_config, 2)
    rng = np.random.default_rng(7)
    scenes = [synthetic.make_scene(cfg, seed=s, **scene_kwargs())
              for s in (2, 3)]
    tg = [jax_build_targets(cfg_j, s.gt_boxes, s.gt_classes, s.gt_valid,
                            s.traj_classes) for s in scenes]
    jt = {k: jnp.stack([t[k] for t in tg]) for k in tg[0]}
    preds = random_preds(cfg, rng, 2)

    def jax_total(p):
        out = jax_loss(cfg_j.model.head, p, jt)
        return out["loss"], out
    (jl, jout), jgrad = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, preds))

    tp = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in preds]
    tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
    out = center_head_loss(cfg.model.head, tp, tt)
    out["loss"].backward()
    for k in ("loss", "hm_loss", "loc_loss"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    assert out["hm_loss"].shape == (7,)
    for t in range(7):
        for k, v in tp[t].items():
            g = np.asarray(jgrad[t][k])
            np.testing.assert_allclose(v.grad.numpy(), g, atol=LOSS_TOL,
                                       rtol=LOSS_TOL, err_msg=f"{t} {k}")
            assert np.abs(g).max() > 0, (t, k)


def test_schedules_match_jax_at_every_step():
    o = port_config.get_config("forecast_n3dtf").train.optim
    total = 50
    for s in range(total):
        c = jnp.asarray(s, jnp.int32)
        want_lr = float(jax_lr(c, total_steps=total, lr_max=o.lr_max,
                               div_factor=o.div_factor,
                               pct_start=o.pct_start))
        want_m = float(jax_mom(c, total_steps=total, moms=o.moms,
                               pct_start=o.pct_start))
        got_lr = one_cycle_lr(s, total_steps=total, lr_max=o.lr_max,
                              div_factor=o.div_factor, pct_start=o.pct_start)
        got_m = one_cycle_momentum(s, total_steps=total, moms=o.moms,
                                   pct_start=o.pct_start)
        assert got_lr == pytest.approx(want_lr, rel=1e-6, abs=0), s
        assert got_m == pytest.approx(want_m, rel=1e-6, abs=0), s
    assert one_cycle_lr(0, total_steps=total, lr_max=o.lr_max,
                        div_factor=o.div_factor,
                        pct_start=o.pct_start) == pytest.approx(1e-4)


class _Params(nn.Module):
    def __init__(self, cfg, arrays):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterList([nn.Parameter(torch.from_numpy(a.copy()))
                                   for a in arrays])


def test_clip_and_adamw_match_optax_over_five_steps():
    """The same gradients into both optimizers: steps 0, 2 and 4 above the
    clip norm of 35, the others below; lr and b1 from the schedule at the
    update count; weight decay on every parameter."""
    cfg_j = jax_config.get_config("forecast_n3dtf")
    cfg = port_config.get_config("forecast_n3dtf")
    rng = np.random.default_rng(11)
    shapes = [(3, 3, 4, 8), (8,), (27, 4, 16), (16,)]
    arrays = [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
    total = 50
    tx = jax_make_optimizer(cfg_j, total)
    jparams = [jnp.asarray(a) for a in arrays]
    jstate = tx.init(jparams)
    model = _Params(cfg, arrays)
    opt = make_optimizer(cfg, model, total)
    update = jax.jit(tx.update)
    for step in range(5):
        scale = 30.0 if step % 2 == 0 else 0.2
        grads = [(rng.normal(0, 1, s) * scale).astype(np.float32)
                 for s in shapes]
        upd, jstate = update([jnp.asarray(g) for g in grads], jstate,
                             jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(model.p, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = apply_update(model, opt, step)
        want_norm = float(optax.global_norm([jnp.asarray(g) for g in grads]))
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        assert (want_norm > 35.0) == (step % 2 == 0)
        for p, jp in zip(model.p, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       atol=OPT_ATOL, rtol=0,
                                       err_msg=f"step {step}")
    assert opt.param_groups[0]["betas"][0] == pytest.approx(
        one_cycle_momentum(4, total_steps=total, moms=cfg.train.optim.moms,
                           pct_start=cfg.train.optim.pct_start))

"""futuredet_torch center_head_loss in every single-stage head mode, and the
multitask target family, against the JAX package on the same numpy-seeded
scenes and head maps: targets (hm and anno_box within 1e-6; ind, mask and
cat equal), the losses within 1e-5 relative, and the gradients with
respect to every head map within 1e-3 of that map's max |g|. The modes:
standard at T = 1 and T = 7 (per-timestep vel slices and the forecast
code weights), multitask class groups, reverse, sparse (both tasks on the
box target of t = 0), classify (the trajectory family) and wide (the
forecast family's heatmap, the trajectory family's boxes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import build_targets as jax_build_targets
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_torch import config as port_config
from futuredet_torch.data import synthetic
from futuredet_torch.data.targets import build_targets_batch
from futuredet_torch.models.losses import center_head_loss
from tests.test_torch_decode_modes import mode_preds
from tests.test_torch_head_modes import MULTITASK
from tests.test_torch_train_parts import (LOSS_TOL, TARGET_ATOL,
                                          scene_kwargs, targets_config)
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

GRAD_FRACTION = 1e-3
MODES = ("standard_t1", "standard_t7", "multitask", "reverse", "sparse",
         "classify", "wide_head")


def loss_config(mod, mode):
    """The small VoxelNet config at a 32 x 32 map with the mode's head:
    the standard sampler, except classify and wide, which read the
    trajectory and forecast families."""
    cfg = targets_config(mod, 2)
    T = 1 if mode in ("standard_t1", "multitask") else 7
    head = dataclasses.replace(
        cfg.model.head, timesteps=T, dense=False, forecast_feature=False,
        code_weights=(1.0,) * 6 + (0.2, 0.2) + (1.0,) * 2)
    data = cfg.data
    if mode == "multitask":
        head = dataclasses.replace(head, tasks=MULTITASK)
        data = dataclasses.replace(data, class_names=tuple(
            n for t in MULTITASK for n in t))
    elif mode not in ("standard_t1", "standard_t7"):
        head = dataclasses.replace(head, **{mode: True})
    sampler = "trajectory" if mode in ("classify", "wide_head") \
        else "standard"
    return cfg.replace(
        timesteps=T, data=data, model=dataclasses.replace(cfg.model,
                                                          head=head),
        assigner=dataclasses.replace(cfg.assigner, sampler_type=sampler))


def both_targets(mode, seeds=(2, 3)):
    cfg, cfg_j = loss_config(port_config, mode), loss_config(jax_config, mode)
    scenes = [synthetic.make_scene(cfg, seed=s, **scene_kwargs())
              for s in seeds]
    fields = ("gt_boxes", "gt_classes", "gt_valid", "traj_classes")
    raw = {f: torch.from_numpy(np.stack([getattr(s, f) for s in scenes]))
           for f in fields}
    got = build_targets_batch(cfg, raw)
    tg = [jax_build_targets(cfg_j, *(getattr(s, f) for f in fields))
          for s in scenes]
    want = {k: np.stack([np.asarray(t[k]) for t in tg]) for k in tg[0]}
    return cfg, cfg_j, got, want


@pytest.mark.parametrize("mode", ["multitask", "standard_t1"])
def test_targets_match_jax(mode):
    cfg, _, got, want = both_targets(mode)
    assert set(got) == set(want) | {"gt_boxes", "gt_valid"}
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.startswith(("hm", "anno_box")):
            np.testing.assert_allclose(g, w, atol=TARGET_ATOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if mode == "multitask":
        # 6 groups on the leading axis, heatmaps padded to 2 channels
        assert got["hm"].shape[1:2] == (6,) and got["hm"].shape[-1] == 2
        assert int(got["mask"].sum()) > 10
        assert got["cat"][got["mask"]].max() == 1
        for t, task in enumerate(MULTITASK):
            if len(task) == 1:
                assert not got["hm"][:, t, ..., 1].any()


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_match_jax(mode):
    cfg, cfg_j, got_t, want_t = both_targets(mode)
    W, H = cfg.feature_map_size
    preds = mode_preds(cfg_j.model.head, np.random.default_rng(7), B=2,
                       H=H, W=W)

    def jax_total(p):
        out = jax_loss(cfg_j.model.head, p, {k: jnp.asarray(v)
                                             for k, v in want_t.items()})
        return out["loss"], out
    (_, jout), jgrad = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, preds))
    tp = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in preds]
    out = center_head_loss(cfg.model.head, tp, got_t)
    out["loss"].backward()
    n_tasks = len(cfg.model.head.num_classes)
    assert out["hm_loss"].shape == out["loc_loss"].shape == (n_tasks,)
    for k in ("loss", "hm_loss", "loc_loss"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=LOSS_TOL,
                                   atol=0, err_msg=k)
    assert float(out["loc_loss"].detach().max()) > 0
    for t in range(n_tasks):
        for k, v in tp[t].items():
            g = np.asarray(jgrad[t][k])
            top = np.abs(g).max()
            if top == 0:
                # a map no target reads (e.g. wide's unused vel slots)
                assert v.grad is None or not v.grad.any(), (t, k)
                continue
            np.testing.assert_allclose(v.grad.numpy(), g, rtol=0,
                                       atol=GRAD_FRACTION * top,
                                       err_msg=f"{mode} task {t} {k}")

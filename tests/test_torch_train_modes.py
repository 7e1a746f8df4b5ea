"""Two train steps at B = 2 of the head modes a config of this repo trains,
futuredet_torch against the JAX package's single-device train step, to the
limits of tests/test_torch_train_step.py: forecast_n3 (the standard head,
vel widened by 7), forecast_n3dtfm (dense + forecast_feature on the
ego map) and centerpoint_multitask (six class groups), each on the small
VoxelNet of tests/test_torch_voxelnet.py from the same weights on the same
batch (the map from `rasterize_scene_map`, several classes an object in
the multitask batch). Each step compares the losses, every gradient and
every new running statistic; between the steps both optimizers take the
JAX gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.train.step import (apply_update, forward_backward,
                                        make_optimizer)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_train_step import (GRAD_FRACTION, LOSS_RTOL,
                                         STAT_ATOL, TOTAL_STEPS,
                                         ZERO_FRACTION, jax_variables,
                                         one_torch_thread)  # noqa: F401
from tests.test_torch_voxelnet import voxelnet_config

NAMES = ("forecast_n3", "forecast_n3dtfm", "centerpoint_multitask")


def mode_config(mod, name):
    """The small VoxelNet with the named config's head, data, sampler and
    timesteps."""
    cfg = voxelnet_config(mod)
    src = mod.get_config(name)
    head = dataclasses.replace(src.model.head,
                               in_channels=cfg.model.head.in_channels,
                               share_conv_channel=16)
    return cfg.replace(
        name=name, timesteps=src.timesteps, data=src.data,
        model=dataclasses.replace(cfg.model, head=head),
        assigner=dataclasses.replace(
            cfg.assigner, sampler_type=src.assigner.sampler_type))


class WithMap:
    """`init` of a JAX detector with the ego map bound, for
    `jax_variables`."""

    def __init__(self, model, bev):
        self.model, self.bev = model, bev

    def init(self, key, pts, valid):
        return self.model.init(key, pts, valid, bev_map=self.bev)


@pytest.fixture(scope="module", params=NAMES)
def run(request):
    name = request.param
    cfg_j, cfg = mode_config(jax_config, name), mode_config(port_config, name)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    bev = batch.get("bev_map")
    bev = None if bev is None else jnp.asarray(bev.numpy())
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}
    model = jax_build(cfg_j)
    variables = jax_variables(
        WithMap(model, None if bev is None else bev[:1]), pts[:1],
        valid[:1])

    def loss_fn(params, batch_stats, pts, valid, raw, bev):
        targets = jax_build_targets_batch(cfg_j, raw)
        out, mut = model.apply({"params": params,
                                "batch_stats": batch_stats}, pts, valid,
                               bev_map=bev, train=True,
                               mutable=["batch_stats", "intermediates"])
        losses = jax_loss(cfg_j.model.head, out, targets)
        return losses["loss"], (losses, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = jax_make_optimizer(cfg_j, TOTAL_STEPS)
    params, stats = variables["params"], variables["batch_stats"]
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
            jax.tree.map(jnp.asarray, raw), bev)
        grads = jax.device_get(grads)
        opt.zero_grad(set_to_none=True)
        port_losses = forward_backward(torch_model, batch)
        steps.append(dict(
            jax_losses=jax.device_get(losses), jax_grads=grads,
            jax_stats=jax.device_get(new_stats),
            losses={k: v.detach().numpy() for k, v in port_losses.items()},
            grads={n: p.grad.numpy().copy()
                   for n, p in torch_model.named_parameters()},
            stats={n: b.numpy().copy()
                   for n, b in torch_model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}))
        upd, opt_state = tx.update(grads, opt_state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params,
                                             upd))
        stats = new_stats
        jax_sd = flax_to_state_dict({"params": grads}, cfg)
        for n, p in torch_model.named_parameters():
            p.grad = jax_sd[n].clone()
        apply_update(torch_model, opt, step)
    return dict(cfg=cfg, steps=steps, batch=batch)


def test_losses_match_jax(run):
    for st in run["steps"]:
        for k in ("loss", "hm_loss", "loc_loss"):
            np.testing.assert_allclose(st["losses"][k],
                                       np.asarray(st["jax_losses"][k]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=k)
        assert st["losses"]["hm_loss"].shape == \
            (len(run["cfg"].model.head.num_classes),)


def test_every_gradient_matches_jax(run):
    for step, st in enumerate(run["steps"]):
        want = flax_to_state_dict({"params": st["jax_grads"]}, run["cfg"])
        assert set(want) == set(st["grads"])
        top = max(float(w.abs().max()) for w in want.values())
        real = {}
        for name, g in st["grads"].items():
            w = want[name].numpy()
            scale = float(np.abs(w).max())
            if scale <= ZERO_FRACTION * top:
                assert float(np.abs(g).max()) <= 2 * ZERO_FRACTION * top, \
                    name
            else:
                real[name] = float(np.abs(g - w).max()) / scale
        worst = max(real, key=real.get)
        assert real[worst] <= GRAD_FRACTION, (step, worst, real[worst])
        # the head's new parts train
        assert any(n.startswith(("bbox_head.bev_conv", "bbox_head.tasks.5",
                                 "bbox_head.tasks.0.vel")) for n in real)


def test_running_statistics_match_jax(run):
    for st in run["steps"]:
        want = flax_to_state_dict({"params": st["jax_grads"],
                                   "batch_stats": st["jax_stats"]},
                                  run["cfg"])
        keys = [k for k in want
                if k.endswith(("running_mean", "running_var"))]
        assert set(keys) == set(st["stats"])
        for k in keys:
            np.testing.assert_allclose(st["stats"][k], want[k].numpy(),
                                       atol=STAT_ATOL, rtol=0, err_msg=k)


def test_the_batch_carries_what_the_mode_reads(run):
    cfg, batch = run["cfg"], run["batch"]
    W, H = cfg.feature_map_size
    if cfg.model.head.bev_map:
        assert batch["bev_map"].shape == (2, H, W, 1)
        assert 0 < float(batch["bev_map"].mean()) < 1
    else:
        assert "bev_map" not in batch
    if cfg.model.head.multitask:
        assert len(set(batch["gt"]["classes"][batch["gt"]["valid"]])) > 3

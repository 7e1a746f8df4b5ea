"""The training slice as a whole: two train steps of the small VoxelNet
forecast_n3dtf (the 64 x 64 x 41 grid of tests/test_torch_voxelnet.py) at
B = 2, futuredet_torch against the JAX package's single-device train step
(the `local_step` of `futuredet_tpu/train/step.py::make_train_step`: on-
device targets, train-mode apply, center_head_loss, value_and_grad, then
its `make_optimizer`), from the same weights (`flax_to_state_dict`) on the
same batch.

Each step compares the loss and its per-task parts, every parameter's
gradient (the JAX gradient tree through the params-only bridge) and every
new running statistic. Between the steps both optimizers take the JAX
gradients: a first AdamW step moves each parameter by about lr * sign(g),
so gradients that differ by rounding alone would leave the two models
2 * lr apart wherever a gradient is near zero; the port's update is held
to optax's on the same gradients instead.

Every BatchNorm gets a bias near 3, so no ReLU input lies near 0. With
random weights some do otherwise, and a ReLU decision that rounding flips between two fp32 implementations (as between the port
in fp32 and in fp64 on these inputs) moves the gradients of the layers
before it by a few per cent of their largest entry; the flips, not the
arithmetic, would then set the tolerance.

The two samples hold different numbers of voxels, so the middle's per-
sample BatchNorm statistics (the JAX `nn.vmap`) differ from statistics
pooled over the batch. The JAX forward drops no site (its stage capacities
hold every cell); the port never drops one. The JAX weights come from
shapes (`jax.eval_shape`, no init compile) filled from a numpy generator;
one JAX compile of the step serves both steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu import config as jax_config
from futuredet_tpu.data.targets import \
    build_targets_batch as jax_build_targets_batch
from futuredet_tpu.models.detector import build_detector as jax_build
from futuredet_tpu.models.detector import extract_dropped_sites
from futuredet_tpu.models.losses import center_head_loss as jax_loss
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models.detector import build_detector
from futuredet_torch.train.step import (apply_update, forward_backward,
                                        make_optimizer)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_voxelnet import voxelnet_config

TOTAL_STEPS = 20
# fp32 through 20 sparse convs, the RPN and 7 heads, summed in another
# order than XLA:CPU
LOSS_RTOL = 1e-5
# per tensor, of its max |JAX gradient| (measured worst 8e-5); a tensor
# whose largest JAX gradient is below ZERO_FRACTION of the model's largest
# is zero up to rounding (a conv bias under a train-mode BatchNorm), and
# its port gradient must be as small
GRAD_FRACTION = 1e-3
ZERO_FRACTION = 1e-6
STAT_ATOL = 1e-5
PARAM_ATOL = 1e-6        # AdamW on the same gradients, optax vs torch
BN_BIAS = 3.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models here run fastest on one thread, and the suite runs
    in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_variables(model, pts, valid):
    """The JAX detector's variables: shapes from jax.eval_shape, LeCun-
    normal kernels, conv biases near 0, BatchNorm scales near 1 and
    biases near BN_BIAS, the heatmap bias of the reference, and random
    running statistics."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)))
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        name = keys[-1]
        if name in ("kernel", "adapt_kernel"):     # the DCN's (9, in, out)
            v = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name == "scale":
            v = rng.normal(1.0, 0.1, leaf.shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.1, leaf.shape)
            if keys[-2] == "hm_final":
                v = np.full(leaf.shape, -2.19)
            elif keys[-2].startswith("bn") or "BatchNorm" in keys[-2] \
                    or "_bn" in keys[-2]:
                v = v + BN_BIAS
        elif name == "mean":
            v = rng.normal(0.0, 0.1, leaf.shape)
        else:
            assert name == "var", keys
            v = rng.uniform(0.5, 1.5, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def run():
    cfg_j = voxelnet_config(jax_config)
    cfg = voxelnet_config(port_config)
    batch = make_batch(cfg, 2, seed=10, n_objects=10, n_clutter=600,
                       points_per_object=150)
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}
    model = jax_build(cfg_j)
    variables = jax_variables(model, pts[:1], valid[:1])

    def loss_fn(params, batch_stats, pts, valid, raw):
        targets = jax_build_targets_batch(cfg_j, raw)
        out, mut = model.apply({"params": params,
                                "batch_stats": batch_stats}, pts, valid,
                               train=True,
                               mutable=["batch_stats", "intermediates"])
        losses = jax_loss(cfg_j.model.head, out, targets)
        return losses["loss"], (losses, mut["batch_stats"],
                                mut["intermediates"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = jax_make_optimizer(cfg_j, TOTAL_STEPS)
    update = jax.jit(tx.update)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    torch_model = build_detector(cfg, device="cpu")
    torch_model.load_state_dict(flax_to_state_dict(variables, cfg),
                                strict=True)
    torch_model.train()
    opt = make_optimizer(cfg, torch_model, TOTAL_STEPS)
    steps = []
    for step in range(2):
        (_, (losses, new_stats, inter)), grads = grad_fn(
            params, stats, jnp.asarray(pts), jnp.asarray(valid),
            jax.tree.map(jnp.asarray, raw))
        grads = jax.device_get(grads)
        opt.zero_grad(set_to_none=True)
        port_losses = forward_backward(torch_model, batch)
        steps.append(dict(
            jax_losses=jax.device_get(losses), jax_grads=grads,
            jax_stats=jax.device_get(new_stats),
            drops=extract_dropped_sites(inter),
            losses={k: v.detach().numpy() for k, v in port_losses.items()},
            grads={n: p.grad.numpy().copy()
                   for n, p in torch_model.named_parameters()},
            stats={n: b.numpy().copy()
                   for n, b in torch_model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))},
            voxels=list(torch_model.num_voxels),
            sites=list(torch_model.backbone.site_counts)))
        # both optimizers take the JAX gradients
        upd, opt_state = update(grads, opt_state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params,
                                             upd))
        stats = new_stats
        jax_sd = flax_to_state_dict({"params": grads}, cfg)
        for n, p in torch_model.named_parameters():
            p.grad = jax_sd[n].clone()
        apply_update(torch_model, opt, step)
        steps[-1]["params_after"] = (
            {n: p.detach().numpy().copy()
             for n, p in torch_model.named_parameters()},
            flax_to_state_dict({"params": params}, cfg))
    return dict(cfg=cfg, steps=steps)


@pytest.mark.parametrize("step", [0, 1])
def test_loss_matches_jax(run, step):
    st = run["steps"][step]
    np.testing.assert_array_equal(st["drops"], [0, 0, 0])
    for k in ("loss", "hm_loss", "loc_loss"):
        np.testing.assert_allclose(st["losses"][k],
                                   np.asarray(st["jax_losses"][k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    assert st["losses"]["hm_loss"].shape == (7,)


def grad_errors(run, step):
    """Per parameter: max |port - JAX| / max |JAX| (None for a tensor that
    is zero up to rounding, whose port gradient is checked here)."""
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"]}, run["cfg"])
    assert set(want) == set(st["grads"])
    top = max(float(w.abs().max()) for w in want.values())
    out = {}
    for name, g in st["grads"].items():
        w = want[name].numpy()
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        if scale <= ZERO_FRACTION * top:
            assert float(np.abs(g).max()) <= 2 * ZERO_FRACTION * top, name
            out[name] = None
        else:
            out[name] = float(np.abs(g - w).max()) / scale
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_every_gradient_matches_jax(run, step):
    errs = grad_errors(run, step)
    real = {n: e for n, e in errs.items() if e is not None}
    worst = max(real, key=real.get)
    assert real[worst] <= GRAD_FRACTION, (worst, real[worst])
    # every sparse conv weight and middle BatchNorm trains
    assert all(errs[n] is not None for n in errs
               if n.startswith("backbone.") and not n.endswith(".bias"))
    assert len(real) > len(errs) // 2


@pytest.mark.parametrize("step", [0, 1])
def test_running_statistics_match_jax(run, step):
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"],
                               "batch_stats": st["jax_stats"]}, run["cfg"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert set(keys) == set(st["stats"])
    for k in keys:
        np.testing.assert_allclose(st["stats"][k], want[k].numpy(),
                                   atol=STAT_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_the_update_of_the_same_gradients_matches_optax(run, step):
    got, want = run["steps"][step]["params_after"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


def test_the_samples_differ_in_voxels_and_the_port_drops_none(run):
    st = run["steps"][0]
    cfg = run["cfg"]
    v0, v1 = st["voxels"]
    assert v0 != v1 and max(v0, v1) < cfg.voxel.max_voxels_train
    assert st["sites"][0] == v0 + v1
    # the second step sees the same batch: the same sites
    assert run["steps"][1]["sites"] == st["sites"]

"""Training of the pillar model, pp_forecast_n3dtf, futuredet_torch against
the JAX package on the same numpy-seeded inputs and weights:

  * the tie rule of the pillar max: `_segment_max` and `torch.maximum`
    split the gradient of tied values evenly, as `jax.ops.segment_max` and
    `jnp.maximum` do (exact);
  * `PillarFeatureNetDirect` in train mode against the flax reader, with
    the pad floor off (cap 0) and on (cap 10), two PFN layers: the canvas
    within 1e-5, the new running statistics within 1e-6, every parameter
    gradient of a random projection of the canvas within 1e-5 of
    max(1, max |JAX|). The scene holds pillars over and under the cap,
    duplicated points (exact ties in the max) and channels that ReLU sets
    to zero everywhere (ties at zero). The phantom row of the floor is
    normalised with the running statistics just updated, updates nothing
    and carries gradient; the test shows that its batch statistics, or a
    second update, would be far off;
  * two train steps of `tiny_variant(pp_forecast_n3dtf)` at B = 2 against
    the JAX single-device train step (the `local_step` of
    `futuredet_tpu/train/step.py::make_train_step`: on-device targets,
    train-mode apply, center_head_loss, value_and_grad, its
    `make_optimizer`), from the same weights: loss (5e-5 relative), every
    gradient (1e-3 of its max |JAX|) and every
    running statistic (1e-5), and the port's AdamW update of the JAX
    gradients against optax's (1e-6). Every BatchNorm bias is raised by 3
    so that few ReLU decisions lie near 0 (see tests/test_torch_train_step.py);
    the pad floor is then active for about half of the points. Even so, a
    ReLU or max decision within rounding of its tie is common at this size:
    for many batch seeds some step's gradients differ from JAX's by per
    cents of a tensor's max, and by as much from the port's own after a
    1e-6 relative nudge of its weights, while the port in float32 agrees
    with itself in float64. The seed here, 33, has no decision that close
    in either step.

The reader runs un-jitted in JAX (op by op); the whole step is one JAX
compile in a module fixture."""
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
from futuredet_tpu.models.readers import \
    PillarFeatureNetDirect as JaxPFNDirect
from futuredet_tpu.train.step import make_optimizer as jax_make_optimizer
from futuredet_torch import config as port_config
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.models import readers
from futuredet_torch.models.detector import build_detector
from futuredet_torch.models.readers import PillarFeatureNetDirect
from futuredet_torch.train.step import (apply_update, forward_backward,
                                        make_optimizer)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_readers import randomize, scene
from tests.test_torch_train_step import (  # noqa: F401 (a fixture)
    grad_errors, jax_variables, one_torch_thread)

# the reader: one Linear + BN per layer and exact max pooling
OUT_ATOL = 1e-5
READER_GRAD_RTOL = 1e-5
READER_STAT_ATOL = 1e-6
# the whole step (as tests/test_torch_train_step.py)
TOTAL_STEPS = 20
# the loss and each task's part: the focal loss sums logs of 2 x 32 x 32
# sigmoids in fp32, in another order than XLA:CPU (measured worst 1.3e-5,
# a task's heatmap loss)
LOSS_RTOL = 5e-5
GRAD_FRACTION = 1e-3
STAT_ATOL = 1e-5
PARAM_ATOL = 1e-6

PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VOXEL = (0.5, 0.5)
GRID = (32, 32)
FILTERS = (16, 16)
# layer-0 channels whose BatchNorm bias is set far below 0: ReLU zeros
# them for every point, so every pillar ties at 0 there
DEAD_CHANNELS = 3


def test_pillar_max_splits_ties_as_jax():
    vals = np.array([[3.0], [3.0], [1.0], [5.0], [5.0], [5.0]], np.float32)
    seg = np.array([0, 0, 0, 1, 1, 1])
    up = np.array([[3.0], [1.0]], np.float32)

    def jf(v):
        return jnp.sum(jax.ops.segment_max(v, jnp.asarray(seg),
                                           num_segments=2) * up)
    want = np.asarray(jax.grad(jf)(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_()
    out = readers._segment_max(v, torch.from_numpy(seg), 2)
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), want)
    np.testing.assert_allclose(want[:, 0], [1.5, 1.5, 0, 1 / 3, 1 / 3, 1 / 3],
                               rtol=1e-7)

    a = np.array([1.0, 2.0, 2.0], np.float32)
    b = np.array([1.0, 1.0, 2.0], np.float32)
    ja, jb = jax.grad(lambda a, b: jnp.sum(jnp.maximum(a, b)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    torch.maximum(ta, tb).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.grad.numpy(), [0.5, 1.0, 0.5])


def tie_scene(rng):
    """tests/test_torch_readers.py's scene (clusters over the cap, scattered
    points under it, points out of range, invalid rows), with 150 points
    of each sample duplicated."""
    pts, valid = scene(rng)
    pts[:, 1500:1650] = pts[:, :150]
    valid[:, 1500:1650] = valid[:, :150]
    return pts, valid


def reader_variables(jm, pts, valid, rng):
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                  jnp.asarray(valid)), rng)
    bias = np.array(variables["params"]["MaskedBatchNorm_0"]["bias"])
    bias[:DEAD_CHANNELS] = -50.0
    variables["params"]["MaskedBatchNorm_0"]["bias"] = bias
    return variables


def port_reader(variables, cap):
    cfg = port_config.get_config("pp_forecast_n3dtf")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                pillar_filters=FILTERS))
    sd = flax_to_state_dict({"params": {"reader": variables["params"]},
                             "batch_stats": {"reader":
                                             variables["batch_stats"]}}, cfg)
    m = PillarFeatureNetDirect(num_input_features=5, num_filters=FILTERS,
                               voxel_size=VOXEL, pc_range=PC_RANGE,
                               grid_hw=GRID, pad_floor_cap=cap)
    m.load_state_dict({k.removeprefix("reader."): v for k, v in sd.items()},
                      strict=True)
    return m.train(), cfg


def port_reader_run(m, pts, valid, proj):
    out = m(torch.from_numpy(pts), torch.from_numpy(valid))
    (out * torch.from_numpy(proj)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return out.detach().numpy(), grads, stats


def assert_close_of_max(got, want, rtol, what):
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("cap", [0, 10])
def test_reader_trains_as_flax(cap):
    rng = np.random.default_rng(21 + cap)
    pts, valid = tie_scene(rng)
    jm = JaxPFNDirect(num_filters=FILTERS, voxel_size=VOXEL,
                      pc_range=PC_RANGE, grid_hw=GRID, pad_floor_cap=cap)
    variables = reader_variables(jm, pts, valid, rng)
    proj = rng.normal(size=(2,) + GRID + (FILTERS[-1],)).astype(np.float32)

    def f(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(pts), jnp.asarray(valid), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, mut["batch_stats"])
    (_, (jout, jstats)), jgrads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])

    m, cfg = port_reader(variables, cap)
    out, grads, stats = port_reader_run(m, pts, valid, proj)
    np.testing.assert_allclose(out, np.asarray(jout), atol=OUT_ATOL, rtol=0)
    want = flax_to_state_dict({"params": {"reader": jgrads},
                               "batch_stats": {"reader": jstats}}, cfg)
    want = {k.removeprefix("reader."): v.numpy() for k, v in want.items()}
    assert set(grads) | set(stats) <= set(want)
    for n, g in grads.items():
        assert_close_of_max(g, want[n], READER_GRAD_RTOL, n)
        # every parameter of both layers trains
        assert np.abs(want[n]).max() > 0, n
    for n, s in stats.items():
        np.testing.assert_allclose(s, want[n], atol=READER_STAT_ATOL, rtol=0,
                                   err_msg=n)
        assert int(dict(m.named_buffers())[
            n.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1

    # the scene holds what the test claims: pillars over and under the cap,
    # exact ties in the max (duplicates) and ties at zero
    ix = np.floor((pts[..., 0] + 8) / 0.5)
    iy = np.floor((pts[..., 1] + 8) / 0.5)
    ok = (valid & (ix >= 0) & (ix < 32) & (iy >= 0) & (iy < 32)
          & (pts[..., 2] >= -3) & (pts[..., 2] <= 3))
    counts = np.bincount((np.arange(2)[:, None] * 1024 + iy * 32 + ix)[ok]
                         .astype(int), minlength=2048)
    assert (counts > 10).sum() >= 8 and ((counts > 0) & (counts < 10)).sum() \
        > 500
    assert ok[:, :150].sum() > 100
    # the dead channels pass no gradient on either side
    for n in ("pfn_layers.0.norm.weight", "pfn_layers.0.norm.bias"):
        assert not want[n][:DEAD_CHANNELS].any()
        assert not grads[n][:DEAD_CHANNELS].any()


@pytest.mark.parametrize("cap", [0, 10])
def test_reader_training_ignores_a_buffer_of_mostly_padding(cap):
    """The reader's gathers read real pillar rows for the points outside
    the grid or the valid mask (so that their backward meets no long run of
    one index): the canvas, the gradients and the running statistics of a
    scene must not move when its buffer is padded to 8x with invalid rows
    that hold in-range coordinates."""
    rng = np.random.default_rng(5 + cap)
    pts, valid = tie_scene(rng)
    pad = scene(rng, P=7 * pts.shape[1])[0]
    pts_pad = np.concatenate([pts, pad], 1)
    valid_pad = np.concatenate([valid, np.zeros(pad.shape[:2], bool)], 1)
    proj = rng.normal(size=(2,) + GRID + (FILTERS[-1],)).astype(np.float32)
    runs = []
    for p, v in ((pts, valid), (pts_pad, valid_pad)):
        torch.manual_seed(0)
        m = PillarFeatureNetDirect(num_input_features=5, num_filters=FILTERS,
                                   voxel_size=VOXEL, pc_range=PC_RANGE,
                                   grid_hw=GRID, pad_floor_cap=cap).train()
        runs.append(port_reader_run(m, p, v, proj))
    (out, grads, stats), (out_p, grads_p, stats_p) = runs
    assert_close_of_max(out_p, out, 1e-6, "canvas")
    for n in grads:
        assert np.abs(grads[n]).max() > 0, n
        assert_close_of_max(grads_p[n], grads[n], 1e-6, n)
    for n in stats:
        assert_close_of_max(stats_p[n], stats[n], 1e-6, n)


def test_reader_phantom_reads_the_updated_statistics_once():
    """With the floor on, a phantom row that took its own batch statistics,
    or whose BatchNorm call updated the running statistics a second time,
    gives a canvas and statistics far from the JAX reader's; the port's
    (the updated statistics, no second update) matches it."""
    cap = 10
    rng = np.random.default_rng(40)
    pts, valid = tie_scene(rng)
    jm = JaxPFNDirect(num_filters=FILTERS, voxel_size=VOXEL,
                      pc_range=PC_RANGE, grid_hw=GRID, pad_floor_cap=cap)
    variables = reader_variables(jm, pts, valid, rng)
    jout, jmut = jm.apply(variables, jnp.asarray(pts), jnp.asarray(valid),
                          train=True, mutable=["batch_stats"])
    cfg = port_reader(variables, cap)[1]
    want = flax_to_state_dict({"params": {"reader": variables["params"]},
                               "batch_stats": {"reader":
                                               jmut["batch_stats"]}}, cfg)
    want_var = want["reader.pfn_layers.1.norm.running_var"].numpy()

    def run(phantom_mode):
        m = port_reader(variables, cap)[0]
        if phantom_mode is not None:
            for layer in m.pfn_layers:
                layer.forward = phantom_mode.__get__(layer)
        with torch.no_grad():
            out = m(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
        return out, m.pfn_layers[1].norm.running_var.numpy()

    def batch_stats_phantom(self, x, valid, phantom=None):
        y = torch.relu(self.norm(self.linear(x), valid))
        if phantom is None:
            return y, None
        # the phantom's own statistics: a train-mode call on it
        return y, torch.relu(self.norm(self.linear(phantom), None))

    def stale_phantom(self, x, valid, phantom=None):
        # the running statistics from before this step's update
        if phantom is not None:
            ph = torch.relu(self.norm.normalize(
                self.linear(phantom), self.norm.running_mean.clone(),
                self.norm.running_var.clone()))
        y = torch.relu(self.norm(self.linear(x), valid))
        return y, None if phantom is None else ph

    out, var = run(None)
    np.testing.assert_allclose(out, np.asarray(jout), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(var, want_var, atol=READER_STAT_ATOL, rtol=0)
    out_b, var_b = run(batch_stats_phantom)
    assert np.abs(out_b - np.asarray(jout)).max() > 100 * OUT_ATOL
    assert np.abs(var_b - want_var).max() > 100 * READER_STAT_ATOL
    out_s, _ = run(stale_phantom)
    assert np.abs(out_s - np.asarray(jout)).max() > 10 * OUT_ATOL


@pytest.fixture(scope="module")
def run():
    cfg_j = jax_config.tiny_variant(jax_config.get_config("pp_forecast_n3dtf"))
    cfg = port_config.tiny_variant(
        port_config.get_config("pp_forecast_n3dtf"))
    batch = make_batch(cfg, 2, seed=33, n_objects=4, n_clutter=300,
                       points_per_object=300)
    pts = batch["points"].numpy()
    valid = batch["points_valid"].numpy()
    raw = {k: v.numpy() for k, v in batch["targets_raw"].items()}
    model = jax_build(cfg_j)
    variables = jax_variables(model, pts[:1], valid[:1])

    def loss_fn(params, batch_stats, pts, valid, raw):
        targets = jax_build_targets_batch(cfg_j, raw)
        out, mut = model.apply({"params": params,
                                "batch_stats": batch_stats}, pts, valid,
                               train=True, mutable=["batch_stats"])
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
            jax.tree.map(jnp.asarray, raw))
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
        # both optimizers take the JAX gradients (optax's update is eager)
        upd, opt_state = tx.update(grads, opt_state, params)
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
    return dict(cfg=cfg, steps=steps, pts=pts, valid=valid)


@pytest.mark.parametrize("step", [0, 1])
def test_pillar_step_loss_matches_jax(run, step):
    st = run["steps"][step]
    for k in ("loss", "hm_loss", "loc_loss"):
        np.testing.assert_allclose(st["losses"][k],
                                   np.asarray(st["jax_losses"][k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    assert st["losses"]["hm_loss"].shape == (7,)


@pytest.mark.parametrize("step", [0, 1])
def test_pillar_step_every_gradient_matches_jax(run, step):
    errs = grad_errors(run, step)
    real = {n: e for n, e in errs.items() if e is not None}
    worst = max(real, key=real.get)
    assert real[worst] <= GRAD_FRACTION, (worst, real[worst])
    # both PFN layers' weights and BatchNorms train
    assert all(errs[n] is not None for n in errs if n.startswith("reader."))
    assert len(real) > len(errs) // 2


@pytest.mark.parametrize("step", [0, 1])
def test_pillar_step_running_statistics_match_jax(run, step):
    st = run["steps"][step]
    want = flax_to_state_dict({"params": st["jax_grads"],
                               "batch_stats": st["jax_stats"]}, run["cfg"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert set(keys) == set(st["stats"])
    assert any(k.startswith("reader.") for k in keys)
    for k in keys:
        np.testing.assert_allclose(st["stats"][k], want[k].numpy(),
                                   atol=STAT_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_pillar_step_update_of_the_same_gradients_matches_optax(run, step):
    got, want = run["steps"][step]["params_after"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


def test_pillar_step_scene_puts_the_floor_in_play(run):
    """Both samples hold pillars under the tiny config's cap of 8 points
    (where the phantom row joins the max) and pillars at or over it."""
    cfg = run["cfg"]
    v = cfg.voxel
    pts, valid = run["pts"], run["valid"]
    W, H, _ = v.grid_size
    ix = np.floor((pts[..., 0] - v.pc_range[0]) / v.voxel_size[0])
    iy = np.floor((pts[..., 1] - v.pc_range[1]) / v.voxel_size[1])
    ok = (valid & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
          & (pts[..., 2] >= v.pc_range[2]) & (pts[..., 2] <= v.pc_range[5]))
    for b in range(2):
        counts = np.bincount((iy[b] * W + ix[b])[ok[b]].astype(int),
                             minlength=H * W)
        assert ((counts > 0) & (counts < v.max_points_per_voxel)).sum() > 100
        assert (counts >= v.max_points_per_voxel).sum() >= 5

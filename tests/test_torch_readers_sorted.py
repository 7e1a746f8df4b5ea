"""futuredet_torch PillarFeatureNet (the sorted, point-major PFN over a
PointVoxelMap) and scatter_to_bev vs the flax module and the jnp function,
with the same weights through the port's bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.models.readers import PillarFeatureNet as JaxPFN
from futuredet_tpu.models.readers import scatter_to_bev as jax_scatter
from futuredet_tpu.ops.voxelize import point_voxel_map as jax_pvm
from futuredet_torch.config import get_config
from futuredet_torch.models.readers import PillarFeatureNet, scatter_to_bev
from futuredet_torch.ops.voxelize import point_voxel_map
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict
from tests.test_torch_readers import randomize, scene
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

# one Linear + BN per layer, segment sums and exact max pooling: only the
# sums' order differs (1e-5 of max(1, max |reference|))
TOL = 1e-5

PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VOXEL = (0.5, 0.5, 6.0)
GRID = (32, 32, 1)
MAX_POINTS = 8
# fewer than the ~700 occupied pillars of a scene: the budget keeps the
# lowest ids
MAX_PILLARS = 500


def maps(pts, valid):
    jm = jax_pvm(jnp.asarray(pts), jnp.asarray(valid), PC_RANGE, VOXEL,
                 grid_size=GRID, max_voxels=MAX_PILLARS,
                 max_points=MAX_POINTS)
    tm = point_voxel_map(torch.from_numpy(pts)[None],
                         torch.from_numpy(valid)[None], PC_RANGE, VOXEL,
                         grid_size=GRID, max_voxels=MAX_PILLARS,
                         max_points=MAX_POINTS)
    return jm, tm


@pytest.fixture(scope="module")
def scene0():
    pts, valid = scene(np.random.default_rng(0), B=1)
    return pts[0], valid[0]


def close(got, want, what):
    tol = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("filters", [(16,), (16, 32)])
@pytest.mark.parametrize("train", [False, True])
def test_sorted_pfn_matches_flax(scene0, filters, train):
    pts, valid = scene0
    jm, tm = maps(pts, valid)
    n = int(jm.num_voxels)
    assert n == MAX_PILLARS == len(tm.first)    # the budget binds
    assert int(np.asarray(jm.num_points).max()) == MAX_POINTS
    np.testing.assert_array_equal(tm.coords.numpy(),
                                  np.asarray(jm.coords)[:n])

    jmod = JaxPFN(num_filters=filters, voxel_size=VOXEL[:2],
                  pc_range=PC_RANGE, max_pillars=MAX_PILLARS)
    variables = jmod.init(jax.random.PRNGKey(1), jm)
    variables = randomize(variables, np.random.default_rng(2))
    cfg = get_config("pp_forecast_n3dtf")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, pillar_filters=filters))
    sd = flax_to_state_dict(
        {k: {"reader": v} for k, v in variables.items()}, cfg)
    assert sd and all(k.startswith("reader.pfn_layers.") for k in sd)
    port = PillarFeatureNet(5, filters, VOXEL[:2], PC_RANGE)
    port.load_state_dict({k.removeprefix("reader."): v
                          for k, v in sd.items()}, strict=True)
    port.train(train)

    if train:
        want, upd = jmod.apply(variables, jm, train=True,
                               mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jm)
    with torch.no_grad():
        got = port(tm).numpy()
    want = np.asarray(want)
    assert got.shape == (n, filters[-1])
    close(got, want[:n], "pooled")
    assert not want[n:].any()
    if train:
        for i in range(len(filters)):
            st = upd["batch_stats"][f"MaskedBatchNorm_{i}"]
            norm = port.pfn_layers[i].norm
            close(norm.running_mean.numpy(), np.asarray(st["mean"]),
                  f"running mean {i}")
            close(norm.running_var.numpy(), np.asarray(st["var"]),
                  f"running var {i}")


def test_scatter_to_bev_matches_jnp(scene0):
    """Valid rows land at y * W + x; rows with coords -1 go to the trash
    row and leave the canvas untouched."""
    pts, valid = scene0
    jm, _ = maps(pts, valid)
    coords = np.asarray(jm.coords).copy()
    coords[::7] = -1                          # some invalid rows
    feats = np.random.default_rng(3).normal(
        0, 1, (len(coords), 6)).astype(np.float32)
    want = np.asarray(jax_scatter(jnp.asarray(feats), jnp.asarray(coords),
                                  GRID[1::-1]))
    got = scatter_to_bev(torch.from_numpy(feats), torch.from_numpy(coords),
                         GRID[1::-1]).numpy()
    assert got.shape == want.shape == (GRID[1], GRID[0], 6)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any(-1).sum() == sum(
        1 for c in coords if c[1] >= 0 and c[2] >= 0)

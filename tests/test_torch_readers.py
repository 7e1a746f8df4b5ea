"""futuredet_torch PillarFeatureNetDirect (sortless pillarization, PFN,
pad floor) vs the flax module, same weights through the port's bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.models.readers import \
    PillarFeatureNetDirect as JaxPFNDirect
from futuredet_torch.config import get_config
from futuredet_torch.models.readers import (MaskedBatchNorm,
                                            PillarFeatureNetDirect)
from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict

# one Linear + BN per layer and exact max pooling: only the matmul's
# summation order differs
ATOL = 1e-5

PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 3.0)
VOXEL = (0.5, 0.5)
GRID = (32, 32)
FILTERS = (16, 16)


def randomize(tree, rng):
    """Random BN statistics, BN affine and biases; kernels keep their
    variance-preserving init so activations stay O(1) through the stack."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            return np.asarray(x)
        a = rng.normal(0, 0.2, np.shape(x)).astype(np.float32)
        if "'var'" in name:
            return np.abs(a) + 0.5
        return a + 1.0 if "'scale'" in name else a
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def scene(rng, B=2, P=2000):
    """~2000 points a sample: a few dense clusters (pillars over the cap of
    8), scattered points (most pillars under it), points out of range in xy
    and z, and invalid padding rows."""
    pts = np.zeros((B, P, 5), np.float32)
    for b in range(B):
        n_clu = 400
        centres = rng.uniform(-7, 7, (8, 2))
        xy = centres[rng.integers(0, 8, n_clu)] + rng.normal(0, 0.15,
                                                              (n_clu, 2))
        xy = np.concatenate([xy, rng.uniform(-9, 9, (P - n_clu, 2))], 0)
        pts[b, :, :2] = xy
        pts[b, :, 2] = rng.uniform(-3.5, 3.5, P)
        pts[b, :, 3:] = rng.uniform(0, 1, (P, 2))
    valid = rng.random((B, P)) < 0.9
    return pts, valid


@pytest.mark.parametrize("cap", [8, 0])
def test_pfn_direct_matches_flax(cap):
    rng = np.random.default_rng(11 + cap)
    pts, valid = scene(rng)
    jm = JaxPFNDirect(num_filters=FILTERS, voxel_size=VOXEL,
                      pc_range=PC_RANGE, grid_hw=GRID, pad_floor_cap=cap)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                  jnp.asarray(valid)), rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(pts),
                               jnp.asarray(valid)))

    cfg = get_config("pp_forecast_n3dtf")
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
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (2, 32, 32, FILTERS[-1])

    # the scene exercises what it claims: pillars under and over the cap,
    # and points dropped for range or validity
    ix = np.floor((pts[..., 0] + 8) / 0.5)
    iy = np.floor((pts[..., 1] + 8) / 0.5)
    ok = (valid & (ix >= 0) & (ix < 32) & (iy >= 0) & (iy < 32)
          & (pts[..., 2] >= -3) & (pts[..., 2] <= 3))
    assert (~ok).sum() > 200
    counts = np.bincount((np.arange(2)[:, None] * 1024 + iy * 32 + ix)[ok]
                         .astype(int), minlength=2048)
    assert (counts > 8).sum() >= 8 and ((counts > 0) & (counts < 8)).sum() > 500
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_masked_bn_training_is_not_ported():
    """MaskedBatchNorm and the pillar reader both train now
    (tests/test_torch_train_sparse.py and tests/test_torch_train_pillars.py
    hold them to the JAX package): a train-mode reader with the pad floor
    updates each layer's running statistics once, the phantom rows adding
    no update, and its canvas's gradient reaches every parameter."""
    bn = MaskedBatchNorm(4).train()
    y = bn(torch.arange(12.0).reshape(3, 4), torch.ones(3, dtype=torch.bool))
    assert y.shape == (3, 4) and int(bn.num_batches_tracked) == 1
    rng = np.random.default_rng(3)
    pts, valid = scene(rng)
    reader = PillarFeatureNetDirect(num_filters=FILTERS, voxel_size=VOXEL,
                                    pc_range=PC_RANGE, grid_hw=GRID,
                                    pad_floor_cap=8).train()
    out = reader(torch.from_numpy(pts), torch.from_numpy(valid))
    out.square().sum().backward()
    for layer in reader.pfn_layers:
        assert int(layer.norm.num_batches_tracked) == 1
        assert not torch.equal(layer.norm.running_mean,
                               torch.zeros_like(layer.norm.running_mean))
    for name, p in reader.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name

"""futuredet_torch/ops/voxelize.py against the JAX package's voxelize_mean
and the numpy oracle of the reference kernel: same points, same voxels.

Coordinates and point counts must agree exactly. Features are means of
fp32 sums taken in another order (the JAX package scans a tree, the port
adds in input order); the points lie on a 2^-8 m lattice, so every sum is
exact in fp32 and the comparison sees the semantics alone (atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.ops.voxelize import voxelize_mean as jax_voxelize_mean
from futuredet_torch.ops.voxelize import (point_voxel_map, points_to_voxel_np,
                                          run_means, voxelize_mean)

PC_RANGE = (-16.0, -16.0, -3.0, 16.0, 16.0, 3.0)
VOXEL = (0.5, 0.5, 0.15)
GRID = (64, 64, 40)
FEAT_ATOL = 1e-6


def lattice_points(rng, P, lo=-16.5, hi=16.5, zlo=-3.2, zhi=3.2, F=5):
    """Points on a 2^-8 m lattice, some of them outside the range."""
    xy = rng.uniform(lo, hi, (P, 2))
    z = rng.uniform(zlo, zhi, (P, 1))
    f = rng.uniform(0, 1, (P, F - 3))
    return (np.round(np.concatenate([xy, z, f], -1) * 256) / 256
            ).astype(np.float32)


def clustered_points(rng, P):
    """Half the points in 24 small blobs (many points per voxel)."""
    pts = lattice_points(rng, P)
    n = P // 2
    centres = rng.uniform(-14, 14, (24, 3)) * np.array([1, 1, 0.15])
    pick = rng.integers(0, 24, n)
    pts[:n, :3] = np.round((centres[pick] + rng.normal(0, 0.4, (n, 3))
                            * np.array([1, 1, 0.3])) * 256) / 256
    return pts


def run_both(pts, valid, max_voxels, max_points):
    kw = dict(grid_size=GRID, max_voxels=max_voxels, max_points=max_points)
    got = voxelize_mean(torch.from_numpy(pts), torch.from_numpy(valid),
                        PC_RANGE, VOXEL, **kw)
    want = jax_voxelize_mean(jnp.asarray(pts), jnp.asarray(valid),
                             jnp.asarray(PC_RANGE), jnp.asarray(VOXEL), **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def assert_same(got, want):
    feats, coords, num, nvox = got
    jf, jc, jn, jv = want
    assert int(nvox) == int(jv)
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(num, jn)
    np.testing.assert_allclose(feats, jf, atol=FEAT_ATOL, rtol=0)


@pytest.mark.parametrize("scene", ["uniform", "clustered"])
def test_voxelize_mean_matches_jax(scene):
    rng = np.random.default_rng(0)
    P = 2048
    pts = (lattice_points if scene == "uniform" else clustered_points)(rng, P)
    valid = rng.random(P) < 0.9
    got, want = run_both(pts, valid, 2048, 8)
    assert_same(got, want)
    assert int(got[3]) > 500


def test_voxel_set_matches_numpy_oracle():
    """The kept voxels, their point counts and their means equal the
    reference kernel's (which orders voxels by first appearance)."""
    rng = np.random.default_rng(1)
    pts = clustered_points(rng, 3000)
    feats, coords, num, nvox = [t.numpy() for t in voxelize_mean(
        torch.from_numpy(pts), torch.ones(3000, dtype=torch.bool), PC_RANGE,
        VOXEL, grid_size=GRID, max_voxels=4096, max_points=6)]
    vox, rc, rn = points_to_voxel_np(pts, VOXEL, PC_RANGE, max_points=6,
                                     max_voxels=4096)
    n = int(nvox)
    assert n == len(rc)
    ref = {tuple(c): (k, vox[i, :k].sum(0) / k)
           for i, (c, k) in enumerate(zip(rc.tolist(), rn))}
    for c, k, f in zip(coords[:n].tolist(), num[:n], feats[:n]):
        rk, rf = ref[tuple(c)]
        assert k == rk
        np.testing.assert_allclose(f, rf, atol=FEAT_ATOL, rtol=0)
    assert (coords[n:] == -1).all() and (num[n:] == 0).all()


def test_first_points_kept_when_a_voxel_overflows():
    """A voxel with 20 points keeps its first 4 in input order."""
    rng = np.random.default_rng(2)
    pts = lattice_points(rng, 64)
    crowd = np.round(rng.uniform(0.01, 0.49, (20, 3)) * 256) / 256
    pts[10:30, :3] = crowd * np.array([1, 1, 0.3]) + np.array([2, 3, 0.0])
    pts[10:30, 3] = np.arange(20)
    got, want = run_both(pts, np.ones(64, bool), 128, 4)
    assert_same(got, want)
    feats, coords, num, _ = got
    i = int(np.flatnonzero((coords == [20, 38, 36]).all(-1))[0])
    assert num[i] == 4
    np.testing.assert_allclose(feats[i, 3], np.mean([0, 1, 2, 3]), atol=0)


def test_points_on_voxel_boundaries():
    """Points exactly on cell faces go to the upper cell; points on the
    upper range face fall out of range."""
    xs = np.array([-16.0, -15.5, 0.0, 0.5, 15.5, 16.0, -0.5, 7.25])
    zs = np.array([-3.0, -2.85, 0.0, 0.15, 2.85, 3.0, 2.7, -1.2])
    pts = np.zeros((64, 5), np.float32)
    pts[:, 0] = np.repeat(xs, 8)
    pts[:, 1] = np.tile(xs, 8)
    pts[:, 2] = np.tile(zs, 8)
    pts[:, 3] = np.arange(64) / 64
    got, want = run_both(pts, np.ones(64, bool), 128, 8)
    assert_same(got, want)
    vox, rc, _ = points_to_voxel_np(pts, VOXEL, PC_RANGE, max_points=8,
                                    max_voxels=128)
    assert int(got[3]) == len(rc)
    assert {tuple(c) for c in got[1][:len(rc)].tolist()} == \
        {tuple(c) for c in rc.tolist()}


def test_out_of_range_and_invalid_points_are_dropped():
    rng = np.random.default_rng(3)
    pts = lattice_points(rng, 256, lo=-40, hi=40, zlo=-9, zhi=9)
    valid = rng.random(256) < 0.5
    got, want = run_both(pts, valid, 256, 8)
    assert_same(got, want)
    inr = ((pts[:, :3] >= np.array(PC_RANGE[:3]))
           & (pts[:, :3] < np.array(PC_RANGE[3:]))).all(-1)
    assert got[2].sum() == (inr & valid).sum()


def test_budget_keeps_the_lowest_ids():
    """With 60 voxels allowed of ~300 occupied, the 60 lowest z-major ids
    stay, ascending."""
    rng = np.random.default_rng(4)
    pts = lattice_points(rng, 400, lo=-15, hi=15, zlo=-2.9, zhi=2.9)
    got, want = run_both(pts, np.ones(400, bool), 60, 8)
    assert_same(got, want)
    coords = got[1]
    ids = (coords[:, 0] * 64 + coords[:, 1]) * 64 + coords[:, 2]
    assert int(got[3]) == 60 and (np.diff(ids) > 0).all()
    _, rc, _ = points_to_voxel_np(pts, VOXEL, PC_RANGE, max_points=8,
                                  max_voxels=4096)
    all_ids = np.sort((rc[:, 0] * 64 + rc[:, 1]) * 64 + rc[:, 2])
    np.testing.assert_array_equal(ids, all_ids[:60])


def test_batch_is_two_single_samples():
    """A (2, P, F) batch gives sample 0's voxels, then sample 1's, each as
    alone, with the budget applied per sample."""
    rng = np.random.default_rng(5)
    pts = np.stack([clustered_points(rng, 1500), lattice_points(rng, 1500)])
    valid = torch.ones(2, 1500, dtype=torch.bool)
    kw = dict(grid_size=GRID, max_voxels=700, max_points=8)
    m = point_voxel_map(torch.from_numpy(pts), valid, PC_RANGE, VOXEL, **kw)
    feats = run_means(m)
    n0 = int(m.num_voxels[0])
    for b, rows in ((0, slice(0, n0)), (1, slice(n0, None))):
        f, c, n, nv = voxelize_mean(torch.from_numpy(pts[b]), valid[b],
                                    PC_RANGE, VOXEL, **kw)
        assert int(nv) == int(m.num_voxels[b]) == len(m.coords[rows])
        assert (m.batch[rows] == b).all()
        torch.testing.assert_close(m.coords[rows], c[:int(nv)], rtol=0,
                                   atol=0)
        torch.testing.assert_close(m.num_points[rows], n[:int(nv)], rtol=0,
                                   atol=0)
        torch.testing.assert_close(feats[rows], f[:int(nv)], rtol=0, atol=0)
    assert int(m.num_voxels[0]) == 700

"""The port's host C++ data path (`futuredet_torch/csrc/host_data.cpp`,
built by g++ at its first use) against the JAX package's library and the
numpy oracles: the threaded sweep loader, the hard voxelizer and the seeded
shuffle; a failed build and an unreadable sweep raise."""
import ctypes
import shutil

import numpy as np
import pytest

from futuredet_torch.ops import _build
from futuredet_torch.ops.voxelize import points_to_voxel_np
from futuredet_torch.utils import native
from futuredet_tpu.utils import native as jax_native


def sweeps(tmp_path, n=6, per=3000, seed=0):
    """A keyframe and n - 1 sweeps as nuScenes .bin files, each with
    points inside the 1 m square, and their transforms and time lags."""
    rng = np.random.default_rng(seed)
    paths, tms, lags = [], [None], [0.0]
    for i in range(n):
        pts = np.concatenate([rng.uniform(-30, 30, (per, 3)),
                              rng.uniform(0, 255, (per, 1)),
                              rng.integers(0, 32, (per, 1))], -1)
        pts[:50, :2] = rng.uniform(-0.99, 0.99, (50, 2))
        p = tmp_path / f"sweep{i}.bin"
        pts.astype(np.float32).tofile(p)
        paths.append(str(p))
        if i:
            a = rng.uniform(-0.2, 0.2)
            tm = np.eye(4)
            tm[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            tm[:3, 3] = rng.normal(0, 2, 3)
            tms.append(tm)
            lags.append(0.05 * i)
    return paths, tms, lags


def numpy_sweeps(paths, tms, lags, keep_feats):
    """The numpy reader of `aggregate_sweeps(use_native=False)`."""
    from futuredet_torch.data.pipeline import read_lidar_bin, remove_close
    out = []
    for i, (p, tm, lag) in enumerate(zip(paths, tms, lags)):
        pts = read_lidar_bin(p, keep_feats)
        if i:
            pts = remove_close(pts, 1.0).T
            hom = np.vstack([pts[:3], np.ones((1, pts.shape[1]))])
            pts[:3] = (np.asarray(tm) @ hom)[:3]
            pts = pts.T
        out.append(np.hstack([pts, np.full((len(pts), 1), lag,
                                           np.float32)]))
    return np.concatenate(out)


@pytest.mark.parametrize("keep_feats", [4, 5])
def test_load_sweeps_matches_the_jax_library_and_numpy(tmp_path,
                                                       keep_feats):
    paths, tms, lags = sweeps(tmp_path)
    got = native.load_sweeps_native(paths, tms, lags, max_points=100000,
                                    keep_feats=keep_feats)
    want = jax_native.load_sweeps_native(paths, tms, lags,
                                         max_points=100000,
                                         keep_feats=keep_feats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, numpy_sweeps(paths, tms, lags,
                                                    keep_feats))
    # the sweeps' close points dropped, the keyframe's kept
    assert got.shape[1] == keep_feats + 1
    assert len(got) <= 6 * 3000 - 5 * 50
    assert (np.abs(got[:3000, :2]) < 1).all(1).sum() >= 50
    # the budget cuts the concatenation in sweep order
    short = native.load_sweeps_native(paths, tms, lags, max_points=7000,
                                      keep_feats=keep_feats)
    np.testing.assert_array_equal(short, got[:7000])


def test_an_unreadable_sweep_raises(tmp_path):
    paths, tms, lags = sweeps(tmp_path, n=3)
    paths[2] = str(tmp_path / "missing.bin")
    with pytest.raises(OSError, match="missing.bin"):
        native.load_sweeps_native(paths, tms, lags, max_points=10000)


def test_voxelize_matches_the_jax_library_and_the_numba_oracle():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-9, 9, (4000, 3)),
                          rng.uniform(0, 1, (4000, 2))], -1
                         ).astype(np.float32)
    # one crowded voxel, past max_points
    pts[:300, :3] = [1.1, 1.1, 0.3] + rng.uniform(0, 0.3, (300, 3))
    args = ((0.5, 0.5, 1.0), (-8, -8, -4, 8, 8, 4), 5, 1000)
    got = native.voxelize_native(pts, *args)
    want = jax_native.voxelize_native(pts, *args)
    oracle = points_to_voxel_np(pts, *args[:2], max_points=5,
                                max_voxels=1000)
    assert len(got[0]) == 1000 and got[2].max() == 5
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_shuffle_matches_the_jax_library():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(5000, 6)).astype(np.float32)
    got, want = pts.copy(), pts.copy()
    native.shuffle_native(got, seed=11)
    jax_native.shuffle_native(want, seed=11)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, pts)
    np.testing.assert_array_equal(np.sort(got, 0), np.sort(pts, 0))
    with pytest.raises(ValueError, match="in place"):
        native.shuffle_native(pts[:, :3], seed=1)     # a strided view


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    shutil.copy(_build.CSRC / "host_data.cpp", src)
    with open(src / "host_data.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed for host_data.cpp"):
        native.shuffle_native(np.zeros((4, 3), np.float32))


def test_the_library_is_loaded_without_the_gil():
    """ctypes.CDLL calls let go of the GIL (PyDLL calls would hold it), so
    the prefetch thread's sweep loads run beside the train step."""
    lib = _build.load("host_data.cpp")
    assert type(lib) is ctypes.CDLL
    assert "-pthread" in _build.CXX_FLAGS

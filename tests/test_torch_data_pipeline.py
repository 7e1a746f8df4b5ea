"""The port's host data pipeline against the JAX package's, bit for bit on
the same seeded inputs: the box geometry, each augmentation and the
per-object noise, the GT database and GT-AUG sampling, whole dataset
samples (train with GT-AUG, CBGS, painted points, the BEV map; eval) on a
fabricated mini nuScenes (`tests/test_infos.py::_mk_mini_nusc`), the
batches, and the prefetcher's order, errors and bound."""
import dataclasses
import os
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.core import boxes
from futuredet_torch.data import augment, gt_database, pipeline, prefetch
from futuredet_tpu.config import get_config as jax_get_config
from futuredet_tpu.config import tiny_variant as jax_tiny_variant
from futuredet_tpu.core import boxes as jax_boxes
from futuredet_tpu.data import augment as jax_augment
from futuredet_tpu.data import gt_database as jax_gt_database
from futuredet_tpu.data import infos as jax_infos
from futuredet_tpu.data import pipeline as jax_pipeline
from tests.test_infos import _mk_mini_nusc
from tests.test_torch_data_infos import assert_same

# the port's torch target rendering against the JAX package's jnp one
# (build_targets, device_targets=False): float32 sums in another order
TARGET_ATOL = 1e-5
PC = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)


def configs(name="forecast_n3dtf", **data):
    """The tiny config of `name` in both packages, the same fields
    replaced: the range and budget of the mini dataset's points, and
    `data`'s fields."""
    max_points = data.pop("max_points", 2048)
    out = []
    for get, tiny in ((get_config, tiny_variant),
                      (jax_get_config, jax_tiny_variant)):
        cfg = tiny(get(name))
        out.append(cfg.replace(
            voxel=dataclasses.replace(
                cfg.voxel, pc_range=(-25.0, -25.0, -5.0, 25.0, 25.0, 3.0),
                max_points=max_points),
            data=dataclasses.replace(cfg.data, nsweeps=3, **data)))
    return out


def scene(rng, n=12, timesteps=7):
    gt = np.zeros((timesteps, n, 12), np.float32)
    gt[..., :3] = rng.uniform(-30, 30, (1, n, 3))
    gt[..., 3:6] = rng.uniform(1, 5, (1, n, 3))
    gt[..., 6:10] = rng.normal(0, 3, (timesteps, n, 4))
    gt[..., 10:] = rng.uniform(-np.pi, np.pi, (timesteps, n, 2))
    pts = rng.uniform(-40, 40, (3000, 6)).astype(np.float32)
    return gt, pts


def test_box_geometry_matches():
    rng = np.random.default_rng(0)
    b = rng.uniform(-20, 20, (30, 7)).astype(np.float32)
    b[:, 3:6] = rng.uniform(1, 5, (30, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, 30)
    corners = boxes.center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6])
    np.testing.assert_allclose(corners, np.asarray(
        jax_boxes.center_to_corner_box2d(jnp.asarray(b[:, :2]),
                                         jnp.asarray(b[:, 3:5]),
                                         jnp.asarray(b[:, 6]))), atol=1e-5)
    # the numpy collision test is the same code on both sides: bit for bit
    q = corners[::-1] + rng.normal(0, 1, corners.shape)
    np.testing.assert_array_equal(boxes.box_collision_test(corners, q),
                                  jax_boxes.box_collision_test(corners, q))
    # points well inside or outside (off the faces by >= 1e-3 relative):
    # the float32 jnp transform and numpy's decide alike
    pts = rng.uniform(-25, 25, (4000, 3)).astype(np.float32)
    got = boxes.points_in_rbbox(pts, b)
    want = np.asarray(jax_boxes.points_in_rbbox(jnp.asarray(pts),
                                                jnp.asarray(b)))
    assert got.any()
    np.testing.assert_array_equal(got, want)
    twelve = np.concatenate([b[:, :6], rng.normal(0, 1, (30, 4)),
                             b[:, 6:7], b[:, 6:7] + 0.3], 1)
    for rng_box in ((-10, -10, 10, 10), (-3, -30, 3, 30)):
        np.testing.assert_array_equal(
            boxes.filter_boxes_outside_range(twelve, rng_box),
            np.asarray(jax_boxes.filter_boxes_outside_range(
                jnp.asarray(twelve), rng_box)))


@pytest.mark.parametrize("seed", range(3))
def test_augmentations_match_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    gt, pts = scene(rng)
    pairs = [
        (lambda m, r: m.random_flip_both(gt, pts, r)),
        (lambda m, r: m.global_rotation(gt, pts, r, (-0.5, 0.5))),
        (lambda m, r: m.global_scaling(gt, pts, r, 0.9, 1.1)),
        (lambda m, r: m.global_translate(gt, pts, r, 0.5)),
        (lambda m, r: m.apply_train_augmentations(
            gt, pts, r, rot_noise=(-0.78, 0.78), scale_noise=(0.9, 1.1),
            translate_std=0.5)),
    ]
    for fn in pairs:
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = fn(augment, r1), fn(jax_augment, r2)
        assert_same(list(got), list(want), "augment")
        assert r1.random() == r2.random()       # the same draws consumed
    bev = rng.uniform(0, 1, (36, 36, 2)).astype(np.float32)
    aug = augment.apply_train_augmentations(
        gt, pts, np.random.default_rng(seed), rot_noise=(-0.78, 0.78),
        scale_noise=(0.9, 1.1), translate_std=0.5)[2]
    assert_same(augment.warp_bev_map(bev, aug, PC),
                jax_augment.warp_bev_map(bev, aug, PC), "warp")


@pytest.mark.parametrize("grot", [0.0, 1.2])
def test_noise_per_object_matches_bit_for_bit(grot):
    """Collision acceptance over 100 tries a box, the radial re-placement
    of the grot mode, and the points that ride with their boxes."""
    rng = np.random.default_rng(3)
    b = np.zeros((10, 7), np.float64)
    b[:, :2] = rng.uniform(-12, 12, (10, 2))
    b[:, 3:6] = [2.0, 4.5, 1.6]
    b[:, 6] = rng.uniform(-np.pi, np.pi, 10)
    pts = np.concatenate([b[:, :3] + rng.uniform(-0.8, 0.8, (10, 3))
                          for _ in range(20)]
                         + [rng.uniform(-15, 15, (200, 3))])
    pts = np.hstack([pts, rng.uniform(0, 1, (len(pts), 2))]).astype(
        np.float32)
    valid = np.ones(10, bool)
    valid[2] = False
    kw = dict(rotation_perturb=0.5, center_noise_std=1.0,
              global_rot_range=grot, num_try=100)
    got = augment.noise_per_object(b, pts, valid,
                                   rng=np.random.default_rng(9), **kw)
    want = jax_augment.noise_per_object(b, pts, valid,
                                        rng=np.random.default_rng(9), **kw)
    assert (got[2] >= 0).sum() >= 5
    assert_same(list(got), list(want), "noise_per_object")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A mini nuScenes of 8 keyframes with a map, its JAX infos, painted
    copies of its sweeps, and the GT database of its train infos built by
    the JAX package."""
    root = tmp_path_factory.mktemp("mini")
    version = _mk_mini_nusc(root, with_map=True)
    paths = jax_infos.create_nuscenes_infos(str(root), version, nsweeps=3,
                                            timesteps=7)
    rng = np.random.default_rng(5)
    painted = root / "sweeps" / "painted_LIDAR_TOP"
    painted.mkdir()
    for fn in os.listdir(root / "sweeps" / "LIDAR_TOP"):
        n = len(np.fromfile(root / "sweeps" / "LIDAR_TOP" / fn,
                            np.float32)) // 5
        pts = np.fromfile(root / "sweeps" / "LIDAR_TOP" / fn,
                          np.float32).reshape(n, 5)
        np.save(painted / f"{fn}.npy", np.hstack(
            [pts, rng.uniform(0, 1, (n, 10)).astype(np.float32)]))
    _, jcfg = configs()
    base = jax_pipeline.NuScenesForecastDataset(jcfg, paths[0], train=False,
                                                class_balanced=False)
    db = jax_gt_database.create_groundtruth_database(jcfg, base, str(root))
    return root, paths[0], db


def test_gt_database_matches(mini, tmp_path):
    root, info_path, db = mini
    cfg, _ = configs()
    ds = pipeline.NuScenesForecastDataset(cfg, info_path, train=False,
                                          class_balanced=False)
    got = gt_database.create_groundtruth_database(cfg, ds, str(tmp_path))
    with open(got, "rb") as f:
        g = pickle.load(f)
    with open(db, "rb") as f:
        w = pickle.load(f)
    assert len(g["car"]) == 16
    assert_same(g, w, "dbinfos")
    for it in g["car"]:
        with open(tmp_path / it["path"], "rb") as f1, \
                open(root / it["path"], "rb") as f2:
            assert f1.read() == f2.read()


@pytest.mark.parametrize("grot", [None, (-1.5, 1.5)])
def test_sample_all_matches(mini, grot):
    """The `_Pool` permutations, the joint collision matrix with its angle
    columns read from -2 and -1, and the pasted points, call after call."""
    root, info_path, db = mini
    groups = {"static_car": 2, "linear_car": 4, "nonlinear_car": 6}
    s = gt_database.DataBaseSampler(db, str(root), groups, seed=4,
                                    sampler_type="trajectory",
                                    global_rot_range=grot)
    j = jax_gt_database.DataBaseSampler(db, str(root), groups, seed=4,
                                        sampler_type="trajectory",
                                        global_rot_range=grot)
    rng = np.random.default_rng(0)
    pasted = 0
    for i in range(6):
        gt, _ = scene(rng, n=i)
        got, want = s.sample_all(gt[0]), j.sample_all(gt[0])
        assert (got is None) == (want is None)
        if got is not None:
            assert_same(got, want, f"sample_all {i}")
            pasted += len(got["gt_names"])
    assert pasted >= 10


SAMPLE_CASES = {
    # name: (train, class_balanced, GT-AUG, painted, config, data fields)
    "train_gtaug_cbgs": (True, True, True, False, "forecast_n3dtf",
                         dict(class_names=("car", "pedestrian"))),
    "train_shuffle": (True, False, True, False, "forecast_n3dtf",
                      dict(max_points=8192)),
    "train_painted": (True, False, False, True, "pp_forecast_n3dtf", {}),
    "train_bev_map": (True, False, True, False, "forecast_n3dtfm", {}),
    "eval": (False, False, False, False, "forecast_n3dtf", {}),
}


def datasets(mini, case):
    root, info_path, db = mini
    train, cbgs, gtaug, painted, name, data = SAMPLE_CASES[case]
    cfg, jcfg = configs(name, **data)
    groups = dict(cfg.data.sample_groups)
    out = []
    for mod, db_mod, c in ((pipeline, gt_database, cfg),
                           (jax_pipeline, jax_gt_database, jcfg)):
        sampler = db_mod.DataBaseSampler(
            db, str(root), groups, sampler_type="trajectory", seed=2) \
            if gtaug else None
        out.append(mod.NuScenesForecastDataset(
            c, info_path, train=train, class_balanced=cbgs, seed=1,
            db_sampler=sampler, painted=painted))
    return cfg, jcfg, out


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_dataset_samples_match_bit_for_bit(mini, case):
    _, _, (ds, jds) = datasets(mini, case)
    assert len(ds) == len(jds) > 0
    assert [i["token"] for i in ds.infos] == [i["token"] for i in jds.infos]
    for i in list(range(len(ds))) * 2:          # the rng streams advance
        got, want = ds.sample(i), jds.sample(i)
        assert_same(got, want, f"{case} sample {i}")
    if SAMPLE_CASES[case][2]:
        assert got["gt_valid"][0].sum() > 2         # pasted objects
    assert got["points"].shape[1] == ds.point_features


@pytest.mark.parametrize("device_targets", [True, False])
def test_batches_match_the_jax_arrays(mini, device_targets):
    cfg, jcfg, (ds, jds) = datasets(mini, "train_gtaug_cbgs")
    got = pipeline.batches_from_dataset(ds, cfg, 2, seed=3,
                                        device_targets=device_targets)
    want = jax_pipeline.batches_from_dataset(jds, jcfg, 2, seed=3,
                                             device_targets=device_targets)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        assert g["tokens"] == w["tokens"]
        assert_same(g["gt"], w["gt"], "gt")
        for k in ("points", "points_valid"):
            assert isinstance(g[k], torch.Tensor) and not g[k].is_pinned()
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        if device_targets:
            for k, v in w["targets_raw"].items():
                assert g["targets_raw"][k].numpy().dtype == \
                    np.asarray(v).dtype
                np.testing.assert_array_equal(g["targets_raw"][k].numpy(),
                                              np.asarray(v))
        else:
            assert g["targets"].keys() == w["targets"].keys()
            for k, v in w["targets"].items():
                np.testing.assert_allclose(
                    g["targets"][k].numpy().astype(np.float64),
                    np.asarray(v).astype(np.float64), atol=TARGET_ATOL,
                    err_msg=k)


def test_one_pass_of_an_eval_set(mini):
    cfg, jcfg, (ds, jds) = datasets(mini, "eval")
    got = list(pipeline.batches_from_dataset(ds, cfg, 1, shuffle=False,
                                             loop=False))
    want = list(jax_pipeline.batches_from_dataset(jds, jcfg, 1,
                                                  shuffle=False, loop=False))
    assert [b["tokens"] for b in got] == [b["tokens"] for b in want] == \
        [[i["token"]] for i in ds.infos]
    with pytest.raises(ValueError, match="smaller than batch_size"):
        next(pipeline.batches_from_dataset(ds, cfg, len(ds) + 1))


@pytest.mark.parametrize("train", [True, False])
def test_info_dataset_is_the_jax_clis_dataset(mini, train):
    """The CLIs' dataset: for training the JAX train CLI's construction
    (GT-AUG from --db_info_path, CBGS, the seed), for evaluation its
    evaluate CLI's (in order, unaugmented); the config takes the points'
    width. A missing pkl stops the CLI."""
    root, info_path, db = mini
    cfg, jcfg = configs()
    kw = dict(seed=1, gt_aug=True, db_info_path=db) if train else {}
    cfg_d, ds = pipeline.info_dataset(cfg, info_path, train=train, **kw)
    if train:
        sampler = jax_gt_database.build_db_sampler(
            jcfg, info_path, db_info_path=db, seed=1)
        assert sampler is not None and ds.db_sampler is not None
        jds = jax_pipeline.NuScenesForecastDataset(
            jcfg, info_path, train=True, seed=1, db_sampler=sampler)
    else:
        assert ds.db_sampler is None
        jds = jax_pipeline.NuScenesForecastDataset(
            jcfg, info_path, train=False, class_balanced=False)
    assert cfg_d.model.num_input_features == ds.point_features == 6
    assert [i["token"] for i in ds.infos] == [i["token"] for i in jds.infos]
    for i in range(len(ds)):
        assert_same(ds.sample(i), jds.sample(i), f"sample {i}")
    with pytest.raises(SystemExit, match="no dataset"):
        pipeline.info_dataset(cfg, str(root / "absent.pkl"), train=train)


def test_numpy_sweep_reader_matches_the_native_one(mini):
    """aggregate_sweeps' two readers give the same array, sweeps with
    points inside the 1 m square included (remove_close drops them from
    sweeps, never from the keyframe)."""
    _, info_path, _ = mini
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    dropped = 0
    for info in infos[2:5]:
        a = pipeline.aggregate_sweeps(info, 3)
        b = pipeline.aggregate_sweeps(info, 3, use_native=False)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, jax_pipeline.aggregate_sweeps(info, 3))
        raw = sum(len(pipeline.read_lidar_bin(p)) for p in
                  [info["lidar_path"]]
                  + [sw["lidar_path"] for sw in info["sweeps"]])
        dropped += raw - len(a)
        key = pipeline.read_lidar_bin(info["lidar_path"])
        assert (np.abs(key[:, :2]) < 1).all(1).any()   # kept in the key
    assert dropped > 0


def test_prefetch_keeps_order_and_its_bound():
    made = []

    def gen():
        for i in range(10):
            made.append(i)
            yield i

    it = prefetch.prefetch(gen(), depth=2)
    time.sleep(0.3)
    # two in the queue and one in hand, blocked on the full queue
    assert len(made) == 3
    assert list(it) == list(range(10))
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_raises_the_threads_error_in_order():
    def gen():
        yield 0
        yield 1
        raise KeyError("broken sample")

    it = prefetch.PrefetchIterator(gen(), depth=4)
    assert next(it) == 0 and next(it) == 1
    with pytest.raises(KeyError, match="broken sample"):
        next(it)
    with pytest.raises(KeyError):
        next(it)
    with pytest.raises(ValueError):
        prefetch.PrefetchIterator(iter([]), depth=0)


def test_prefetch_close_stops_the_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    it = prefetch.prefetch(endless(), depth=2)
    assert next(it) == 0
    it.close()
    assert threading.active_count() == before

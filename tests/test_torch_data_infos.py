"""The port's data preparation against the JAX package's on a fabricated
mini nuScenes (`tests/test_infos.py::_mk_mini_nusc`): the JSON tables and
their helpers, the official splits, `create_nuscenes_infos` (pkls equal
array for array, and each package's pkls read by the other), the ego map's
cubic resize against OpenCV, and the create_data CLI with the GT
database."""
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest

from futuredet_torch.data import infos, nuscenes_tables, splits
from futuredet_tpu.data import infos as jax_infos
from futuredet_tpu.data import nuscenes_tables as jax_tables
from futuredet_tpu.data import splits as jax_splits
from tests.test_infos import _mk_mini_nusc

# the ego map's resize against cv2.resize(INTER_CUBIC): OpenCV rounds in
# float32 where the port's filter sums in float64, so a value within
# rounding of a half may land one level apart
RESIZE_MAX_LEVELS = 1
RESIZE_MAX_FRACTION = 1e-3


def assert_same(a, b, path="info"):
    """Equal, array for array and key for key, down to dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def write_infos(make, root, version, **kw):
    """create_nuscenes_infos of one package; returns its two pkls loaded
    and their raw bytes."""
    paths = make(str(root), version, **kw)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            raw = f.read()
        out.append((pickle.loads(raw), raw))
    return out


def test_tables_and_their_helpers_match(tmp_path):
    version = _mk_mini_nusc(tmp_path, n_samples=4,
                            scene_names=("scene-0061", "scene-0103"),
                            with_map=True)
    t = nuscenes_tables.NuScenesTables(str(tmp_path), version)
    j = jax_tables.NuScenesTables(str(tmp_path), version)
    assert t.sample_tokens_by_scene == j.sample_tokens_by_scene
    for ann in t.table("sample_annotation"):
        np.testing.assert_array_equal(t.box_velocity(ann["token"]),
                                      j.box_velocity(ann["token"]))
        assert t.ann_category(ann) == j.ann_category(ann)
        assert t.ann_attribute(ann) == j.ann_attribute(ann)
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(nuscenes_tables.quat_to_rot(q),
                                      jax_tables.quat_to_rot(q))
        assert nuscenes_tables.quat_yaw(q) == jax_tables.quat_yaw(q)
        np.testing.assert_array_equal(
            nuscenes_tables.transform_matrix([1, 2, 3], q, inverse=True),
            jax_tables.transform_matrix([1, 2, 3], q, inverse=True))
    sd = t.table("sample")[0]["data"]["LIDAR_TOP"]
    ego = t.get_ego_centric_map(sd)
    assert ego.shape == (800, 800) and ego.max() == 255
    np.testing.assert_array_equal(ego, j.get_ego_centric_map(sd))
    assert nuscenes_tables.GENERAL_TO_DETECTION == \
        jax_tables.GENERAL_TO_DETECTION


def test_a_map_without_pil_raises_naming_it(tmp_path, monkeypatch):
    import builtins
    version = _mk_mini_nusc(tmp_path, n_samples=2, with_map=True)
    t = nuscenes_tables.NuScenesTables(str(tmp_path), version)
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    sd = t.table("sample")[0]["data"]["LIDAR_TOP"]
    with pytest.raises(ImportError, match="PIL"):
        t.get_ego_centric_map(sd)


def test_splits_match():
    assert splits.VAL_SCENES == jax_splits.VAL_SCENES
    assert (splits.MINI_TRAIN, splits.MINI_VAL) == \
        (jax_splits.MINI_TRAIN, jax_splits.MINI_VAL)
    names = ["scene-0001", "scene-0003", "scene-0061", "scene-0103",
             "scene-0916", "scene-1073"]
    for version in ("v1.0-trainval", "v1.0-test", "v1.0-mini"):
        assert splits.split_scenes(names, version) == \
            jax_splits.split_scenes(names, version)


@pytest.mark.parametrize("with_map", [False, True])
def test_create_nuscenes_infos_writes_the_jax_pkls(tmp_path, with_map):
    """Both packages' pkls on the same dataset: equal array for array,
    except the ego map's resize (OpenCV's against the port's numpy cubic)
    within RESIZE_MAX_LEVELS at RESIZE_MAX_FRACTION of the pixels; a
    dataset without a raster gives exactly zero maps on both sides."""
    version = _mk_mini_nusc(tmp_path, n_samples=4,
                            scene_names=("scene-0061", "scene-0103"),
                            with_map=with_map)
    kw = dict(nsweeps=3, timesteps=7)
    want = write_infos(jax_infos.create_nuscenes_infos, tmp_path, version,
                       **kw)
    got = write_infos(infos.create_nuscenes_infos, tmp_path, version, **kw)
    n_maps = 0
    for (g, graw), (w, _) in zip(got, want):
        assert len(g) == len(w) == 4
        assert b"futuredet" not in graw      # numpy and builtins only
        for gi, wi in zip(g, w):
            gb, wb = gi.pop("bev"), wi.pop("bev")
            assert gb.dtype == wb.dtype == np.uint8
            assert gb.shape == wb.shape == (180, 180)
            d = np.abs(gb.astype(int) - wb.astype(int))
            assert d.max() <= RESIZE_MAX_LEVELS
            assert (d > 0).mean() <= RESIZE_MAX_FRACTION
            if not with_map:
                assert gb.max() == 0 and wb.max() == 0
            n_maps += int(gb.max() > 0)
            assert_same(gi, wi)
    assert n_maps == (8 if with_map else 0)


def test_each_package_reads_the_others_pkls(tmp_path):
    """Samples of the port's dataset on the JAX pkl and of the JAX dataset
    on the port's pkl are identical to each package's own."""
    from futuredet_torch.config import get_config, tiny_variant
    from futuredet_torch.data.pipeline import NuScenesForecastDataset
    from futuredet_tpu.config import get_config as jax_get_config
    from futuredet_tpu.config import tiny_variant as jax_tiny_variant
    from futuredet_tpu.data.pipeline import \
        NuScenesForecastDataset as JaxDataset

    version = _mk_mini_nusc(tmp_path, n_samples=3)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jpaths = jax_infos.create_nuscenes_infos(str(tmp_path), version, 3, 7)
    for p in jpaths:
        os.replace(p, jdir / os.path.basename(p))
    ppaths = infos.create_nuscenes_infos(str(tmp_path), version, 3, 7)
    for p in ppaths:
        os.replace(p, pdir / os.path.basename(p))
    name = os.path.basename(jpaths[0])
    cfg = tiny_variant(get_config("forecast_n3dtf"))
    jcfg = jax_tiny_variant(jax_get_config("forecast_n3dtf"))
    own = NuScenesForecastDataset(cfg, str(pdir / name), train=False)
    jown = JaxDataset(jcfg, str(jdir / name), train=False)
    cross = NuScenesForecastDataset(cfg, str(jdir / name), train=False)
    jcross = JaxDataset(jcfg, str(pdir / name), train=False)
    for i in range(len(own)):
        a, b = own.sample(i), cross.sample(i)
        ja, jb = jown.sample(i), jcross.sample(i)
        for s in (b, ja, jb):
            assert_same(a, s, f"sample {i}")


def test_resize_cubic_matches_opencv():
    rng = np.random.default_rng(0)
    zero = np.zeros((800, 800), np.uint8)
    assert infos.resize_cubic_u8(zero, (180, 180)).max() == 0
    binary = np.where(rng.random((800, 800)) < 0.3, 255, 0).astype(np.uint8)
    binary[:400] = 255
    for img in (binary, rng.integers(0, 256, (800, 800)).astype(np.uint8)):
        for dsize in ((180, 180), (71, 33)):
            got = infos.resize_cubic_u8(img, dsize)
            want = cv2.resize(img, dsize=dsize,
                              interpolation=cv2.INTER_CUBIC)
            assert got.shape == want.shape
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= RESIZE_MAX_LEVELS
            assert (d > 0).mean() <= RESIZE_MAX_FRACTION


def test_create_data_cli_matches_the_jax_cli(tmp_path):
    """nuscenes_data_prep --gt_database of both CLIs: the same infos, the
    same dbinfos and the same database files."""
    from futuredet_torch.cli import create_data
    from futuredet_tpu.cli import create_data as jax_create_data

    version = _mk_mini_nusc(tmp_path, n_samples=4,
                            scene_names=("scene-0061", "scene-0103"))
    argv = ["nuscenes_data_prep", "--root_path", str(tmp_path), "--version",
            version, "--nsweeps", "3", "--gt_database", "--model",
            "forecast_n3dtf"]

    def run(main):
        paths = main(argv)
        out = {}
        for p in paths + [str(tmp_path / "dbinfos_train_3sweeps_withvelo"
                              ".pkl")]:
            with open(p, "rb") as f:
                out[os.path.basename(p)] = pickle.load(f)
        db = tmp_path / "gt_database_3sweeps_withvelo"
        for d, _, files in os.walk(db):
            for fn in files:
                with open(os.path.join(d, fn), "rb") as f:
                    out[os.path.relpath(os.path.join(d, fn), db)] = f.read()
        return out

    want = run(jax_create_data.main)
    shutil.rmtree(tmp_path / "gt_database_3sweeps_withvelo")
    got = run(create_data.main)
    assert got.keys() == want.keys()
    db = got["dbinfos_train_3sweeps_withvelo.pkl"]
    assert len(db["car"]) == 8 and len(got) == 3 + 8
    assert_same(got, want, "create_data")
    cfg = create_data.gt_database_config("forecast_n3dtf", 3)
    assert cfg.data.nsweeps == 3 and cfg.data.sample_groups == ()

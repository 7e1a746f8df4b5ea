"""The port's Waymo decoded-frame support against the JAX package's, on
the synthetic decoded layout of `tests/test_waymo.py`: infos with their
sweep chains, dataset samples, the prediction dump's pkl fallback, the
box conversions, the data-prep CLI, and the gated tfrecord decoder."""
import os
import pickle

import numpy as np
import pytest

from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.data import waymo
from futuredet_tpu.config import get_config as jax_get_config
from futuredet_tpu.config import tiny_variant as jax_tiny_variant
from futuredet_tpu.data import waymo as jax_waymo
from tests.test_torch_data_infos import assert_same
from tests.test_waymo import _make_decoded_dataset


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("nsweeps", [1, 3])
def test_infos_and_samples_match(tmp_path, nsweeps):
    root = str(tmp_path)
    _make_decoded_dataset(root, n_frames=4)
    want = load(jax_waymo.create_waymo_infos(root, "train", nsweeps))
    path = waymo.create_waymo_infos(root, "train", nsweeps)
    got = load(path)
    assert len(got) == 8
    assert_same(got, want, "waymo infos")
    cfg = tiny_variant(get_config("forecast_n3dtf"))
    jcfg = jax_tiny_variant(jax_get_config("forecast_n3dtf"))
    cfg = cfg.replace(data=cfg.data.__class__(nsweeps=nsweeps))
    jcfg = jcfg.replace(data=jcfg.data.__class__(nsweeps=nsweeps))
    ds = waymo.WaymoDataset(cfg, path, seed=3, load_interval=2)
    jds = jax_waymo.WaymoDataset(jcfg, path, seed=3, load_interval=2)
    assert len(ds) == len(jds) == 4
    for i in range(len(ds)):
        assert_same(ds.sample(i), jds.sample(i), f"waymo sample {i}")


def test_box_conversions_match():
    rng = np.random.default_rng(0)
    raw = rng.normal(0, 3, (20, 9)).astype(np.float32)
    assert_same(waymo.convert_box_to_kitti(raw),
                jax_waymo.convert_box_to_kitti(raw))
    dets = rng.normal(0, 3, (20, 9))
    assert_same(waymo.convert_detection_to_waymo(dets),
                jax_waymo.convert_detection_to_waymo(dets))
    frames = ["seq_1_frame_0.pkl", "seq_0_frame_12.pkl", "seq_0_frame_2.pkl"]
    assert waymo.sort_frame(frames) == jax_waymo.sort_frame(frames)


def test_prediction_dump_pkl_fallback_matches(tmp_path):
    root = str(tmp_path)
    _make_decoded_dataset(root, n_frames=2)
    infos = load(waymo.create_waymo_infos(root, "train", 1))
    rng = np.random.default_rng(1)
    dets = {i["token"]: {"box3d_lidar": rng.normal(0, 2, (3, 9)),
                         "scores": rng.uniform(0, 1, 3),
                         "label_preds": rng.integers(0, 3, 3)}
            for i in infos}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_waymo.create_pd_detection(dets, infos, str(tmp_path / "jax"))
    got = waymo.create_pd_detection(dets, infos, str(tmp_path / "port"))
    assert os.path.basename(got) == "detection_pred.pkl"
    records = load(got)
    assert len(records) == 12
    assert_same(records, load(want), "pd records")


def test_waymo_data_prep_cli_and_the_gated_decoder(tmp_path):
    from futuredet_torch.cli import create_data
    _make_decoded_dataset(str(tmp_path))
    paths = create_data.main(["waymo_data_prep", "--root_path",
                              str(tmp_path), "--split", "train",
                              "--nsweeps", "2"])
    assert paths == [os.path.join(
        str(tmp_path), "infos_train_02sweeps_filter_zero_gt.pkl")]
    assert len(load(paths[0])) == 8
    with pytest.raises(ImportError, match="tensorflow"):
        waymo.decode_tfrecords("segment.tfrecord")

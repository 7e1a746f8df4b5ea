"""chip_smoke.py's real-data phases (21-22) on the CPU: its nuScenes-format
dataset writer at a small size read back through the tables, and the
phases rehearsed on it with the small configs and counting kernels of
`tests/test_torch_chip_smoke.py`, pinning as a no-op."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tests.test_torch_chip_smoke import (  # noqa: E402,F401
    eval_phases_on_the_cpu, train_phases_on_the_cpu)


def small_dataset(root, keyframes=2, between=2):
    return cs.write_nuscenes(str(root), seed=3, keyframes=keyframes,
                             between=between, points=900, objects=6,
                             extent=12.0, lead=2)


def test_write_nuscenes_reads_back_as_a_dataset(tmp_path):
    from futuredet_torch.data.infos import fill_infos
    from futuredet_torch.data.nuscenes_tables import NuScenesTables
    from futuredet_torch.data.splits import split_scenes

    version = small_dataset(tmp_path, keyframes=8, between=1)
    nusc = NuScenesTables(str(tmp_path), version)
    names = [s["name"] for s in nusc.table("scene")]
    assert split_scenes(names, version) == ([cs.NUSC_SCENES[0]],
                                            [cs.NUSC_SCENES[1]])
    assert [len(v) for v in nusc.sample_tokens_by_scene.values()] == [8, 8]
    # 2 lead sweeps, 8 keyframes with 1 sweep between: 17 a scene
    assert len(nusc.table("sample_data")) == 34
    for sd in nusc.table("sample_data"):
        pts = np.fromfile(tmp_path / sd["filename"], np.float32)
        assert pts.shape == (900 * 5,)
    infos = fill_infos(nusc, nsweeps=3, timesteps=7)
    assert len(infos) == 16
    info = infos[0]
    # the first keyframe's chain: the 2 lead sweeps
    assert len({s["sample_data_token"] for s in info["sweeps"]}) == 2
    assert info["gt_boxes"].shape == (6, 7, 12)
    assert {"static", "linear"} <= set(info["gt_trajectory"][:, 0])
    # velocities: static cars stand, the others move
    speed = np.hypot(*info["gt_boxes"][:, 0, 6:8].T)
    assert (speed[info["gt_trajectory"][:, 0] == "static"] < 1e-6).all()
    assert (speed[info["gt_trajectory"][:, 0] != "static"] > 1).all()
    # a car's surface points, taken to the lidar frame of its sample by
    # the info's own transforms, lie on its box
    from futuredet_torch.core.boxes import points_in_rbbox
    pts = np.fromfile(info["lidar_path"], np.float32).reshape(-1, 5)
    b = info["gt_boxes"][:, 0]
    boxes = np.concatenate([b[:, :3], b[:, 3:6] + 0.05,
                            (-b[:, 10] - np.pi / 2)[:, None]], 1)
    boxes[:, [3, 4]] = boxes[:, [4, 3]]
    inside = points_in_rbbox(pts[:, :3], boxes).any(1)
    assert inside.sum() >= 6
    with open(tmp_path / version / "map.json") as f:
        assert json.load(f)[0]["filename"] == ""


@pytest.fixture
def nusc_phases_on_the_cpu(eval_phases_on_the_cpu, monkeypatch):
    """The evaluation rehearsal's setting, a small dataset, and pinning
    as a no-op (it needs a card)."""
    for name, value in (("NUSC_KEYFRAMES", 3), ("NUSC_SWEEPS_BETWEEN", 1),
                        ("NUSC_SWEEP_POINTS", 900), ("NUSC_OBJECTS", 6),
                        ("NUSC_EXTENT", 12.0), ("NUSC_NSWEEPS", 3),
                        ("NUSC_HOST_REPS", 1), ("NUSC_TURN_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)

    class NoProfiler:
        def start(self):
            pass

        def stop(self):
            pass

        def key_averages(self):
            return []
    monkeypatch.setattr(cs, "cuda_profiler", NoProfiler)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: True)
    return eval_phases_on_the_cpu


def test_nusc_phases_rehearse_on_the_cpu(nusc_phases_on_the_cpu, tmp_path):
    lines = nusc_phases_on_the_cpu
    launches = cs.nusc_path(torch.device("cpu"), "cpu", str(tmp_path))
    steps = cs.NUSC_KEYFRAMES
    assert launches == {
        f"{cs.VOX_NAME}_nusc_train": {"k1": 0, "k2": 39 * steps},
        f"{cs.NAME}_nusc_train": {"k1": 0, "k2": 0},
        f"{cs.VOX_NAME}_nusc_eval": {"k1": steps, "k2": 20 * steps},
        f"{cs.NAME}_nusc_eval": {"k1": steps, "k2": 0}}
    phases = [ln["phase"] for ln in lines]
    assert phases == ["nusc_create_data", "nusc_train_cli", "nusc_train_cli",
                      "nusc_host_times", "nusc_prefetch", "nusc_eval_cli",
                      "nusc_eval_cli", "nusc_checks"]
    prep, vox_train = lines[0], lines[1]
    assert prep["infos_train"] == prep["infos_val"] == steps
    assert prep["db_objects"] > 0
    assert vox_train["launches_per_step"] == [(20, 19, 0)] * steps
    assert len(vox_train["voxels_per_sample"]) == steps
    assert vox_train["tensorboard"] != []
    host = lines[3]
    assert set(host["host_ms"]) == {"native_sweep_load", "gt_aug_sample_all",
                                    "augmentations", "shuffle_and_pack",
                                    "whole_sample"}
    assert host["points_after_pack"] <= host["max_points"]
    pre = lines[4]
    for depth in (2, 0):
        turn = pre[f"prefetch_depth_{depth}"]
        assert len(turn["step_ms"]) == 2 * (cs.NUSC_TURN_STEPS - 1)
        assert 0 <= turn["wait_share"] < 1
        # every period is its step and a wait of at least 0
        assert turn["period_ms_median"] >= turn["step_ms_median"]
    assert pre["step_ms_added_by_the_thread"] == (
        pre["prefetch_depth_2"]["step_ms_median"]
        - pre["prefetch_depth_0"]["step_ms_median"])
    checks = lines[-1]
    for model in (cs.VOX_NAME, cs.NAME):
        assert checks["card_vs_cpu"][model]["hm_max_abs_err"] == 0.0
    assert checks["same_info_twice_identical"]
    assert checks["native_vs_numpy_identical"]

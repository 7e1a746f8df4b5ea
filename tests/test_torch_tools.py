"""futuredet_torch.cli.tools against futuredet_tpu.cli.tools: trajectory
and statistics on the same infos pkls (equal pickles, equal counts), the
trajectory -> snap_to_prototypes chain, compare on two port checkpoints,
visualize (png, mp4, the named error without matplotlib) and the export
round trip of a pillar and a VoxelNet config at the tiny geometry, of the
VoxelNet under `middle_dense_from_stage` 0 and 2, and of the pillars under
`circular_nms`."""
import builtins
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from futuredet_torch.cli import tools
from futuredet_tpu.cli import tools as jax_tools
from tests.test_infos import _mk_mini_nusc
from tests.test_tools import _infos
from tests.test_torch_train_step import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def info_pkls(tmp_path_factory):
    """{source: infos pkl}: the JAX tests' hand-made infos, and the train
    split of a mini nuScenes prepared by the port's create_data."""
    from futuredet_torch.data.infos import create_nuscenes_infos
    root = tmp_path_factory.mktemp("infos")
    version = _mk_mini_nusc(root, scene_names=("scene-0061", "scene-0103"))
    train, _ = create_nuscenes_infos(str(root), version, nsweeps=3,
                                     timesteps=7)
    return {"synthetic": _infos(root), "mini_nuscenes": str(train)}


@pytest.mark.parametrize("source", ["synthetic", "mini_nuscenes"])
def test_trajectory_and_statistics_match_the_jax_tools(info_pkls, source,
                                                       tmp_path):
    path = info_pkls[source]
    ours, theirs = tmp_path / "ours.pkl", tmp_path / "theirs.pkl"
    got = tools.main(["trajectory", "--info_path", path, "--out", str(ours)])
    want = jax_tools.main(["trajectory", "--info_path", path, "--out",
                           str(theirs)])
    assert len(got) == len(want) > 0
    assert ours.read_bytes() == theirs.read_bytes()
    counts = tools.main(["statistics", "--info_path", path])
    assert counts == jax_tools.main(["statistics", "--info_path", path])
    assert sum(counts.values()) > 0


def test_trajectory_prototypes_snap_chain(info_pkls, tmp_path, monkeypatch):
    """tools trajectory -> snap_to_prototypes, as the JAX test: the default
    output name is the file `evaluate --postprocess` reads; a matched
    horizon snaps a curved future onto the nearest prototype, a shorter
    one raises."""
    from futuredet_torch.eval.linking import Trajectory, snap_to_prototypes
    monkeypatch.chdir(tmp_path)
    protos = tools.main(["trajectory", "--info_path",
                         info_pkls["mini_nuscenes"], "--classname", "car"])
    assert (tmp_path / "car_trajectory.pkl").exists()
    assert len(protos) > 0 and len(protos[0]) - 1 == 6
    T = 7
    boxes = np.zeros((T, 9), np.float32)
    t = np.arange(T)
    boxes[:, 0] = 2.0 * t
    boxes[:, 1] = 0.5 * t ** 2
    boxes[:, 3:6] = 2.0
    boxes[:, 6] = 4.0
    tr = Trajectory(boxes=boxes, scores=np.ones(T, np.float32))
    out = snap_to_prototypes([tr], protos)[0]
    assert not np.allclose(boxes[1:, :2], out.boxes[1:, :2])
    short = Trajectory(boxes=boxes[:3], scores=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="different horizon"):
        snap_to_prototypes([short], protos)


def test_compare_two_port_checkpoints(tmp_path):
    """The newest step of each directory; parameters by state_dict name,
    BatchNorm buffers left out as the JAX tool leaves out batch_stats."""
    from futuredet_torch.train.checkpoints import CheckpointManager
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    a, b = tmp_path / "a", tmp_path / "b"
    CheckpointManager(str(a)).save(1, model, opt)
    mb = CheckpointManager(str(b))
    mb.save(1, model, opt)
    with torch.no_grad():
        model[2].weight.add_(1.0)
        model[1].running_mean.add_(1.0)
    mb.save(3, model, opt)
    changed, same = tools.main(["compare", str(a), str(b)])
    assert changed == ["2.weight"]
    assert same == ["0.weight", "0.bias", "1.weight", "1.bias", "2.bias"]


def write_predictions(tmp_path):
    rng = np.random.default_rng(0)
    data = {tok: {"scene_token": sc, "gt": [rng.uniform(-40, 40, (7, 2))],
                  "pred": [rng.uniform(-40, 40, (7, 2))]}
            for tok, sc in [("s0", "sceneA"), ("s1", "sceneA"),
                            ("s2", "sceneB")]}
    p = tmp_path / "preds.pkl"
    with open(p, "wb") as f:
        pickle.dump(data, f)
    return p


def test_visualize_pngs_and_scene_videos(tmp_path):
    import cv2
    p = write_predictions(tmp_path)
    rendered = tools.main(["visualize", "--predictions", str(p),
                           "--out_dir", str(tmp_path), "--video"])
    assert rendered == ["s0", "s1", "s2"]
    assert all((tmp_path / f"{t}.png").stat().st_size > 0 for t in rendered)
    for sc, n_frames in [("sceneA", 2), ("sceneB", 1)]:
        cap = cv2.VideoCapture(str(tmp_path / f"{sc}.mp4"))
        assert cap.isOpened()
        got = 0
        while cap.read()[0]:
            got += 1
        cap.release()
        assert got == n_frames, sc


@pytest.mark.parametrize("hidden,flags", [("matplotlib", []),
                                          ("cv2", ["--video"])])
def test_visualize_without_its_package_names_it(tmp_path, monkeypatch,
                                                hidden, flags):
    p = write_predictions(tmp_path)
    real_import = builtins.__import__

    def hide(name, *a, **kw):
        if name == hidden or name.startswith(hidden + "."):
            raise ImportError(f"No module named '{hidden}'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", hide)
    monkeypatch.setattr("importlib.import_module",
                        lambda name, *a: hide(name))
    with pytest.raises(ImportError, match=f"needs {hidden}"):
        tools.main(["visualize", "--predictions", str(p), "--out_dir",
                    str(tmp_path), *flags])
    assert not list(tmp_path.glob("*.png"))


def circular_nms(cfg):
    return cfg.replace(test=dataclasses.replace(cfg.test, circular_nms=True))


def dense_from(stage):
    def knob(cfg):
        return cfg.replace(model=dataclasses.replace(
            cfg.model, middle_dense_from_stage=stage))
    return knob


# case -> (config name, the knob on its tiny variant, the exported
# program's nms_alive, circle_nms and gather_conv nodes): the circle NMS
# is one node a pseudo-task (7 at B = 1); under middle_dense_from_stage 2
# the first two stages' 10 sparse convs stay K2, under 0 none do
EXPORTS = {
    "pp_forecast_n3dtf": ("pp_forecast_n3dtf", None, (1, 0, 0)),
    "forecast_n0": ("forecast_n0", None, (1, 0, 20)),
    "forecast_n3dtf dense_from_stage 0": ("forecast_n3dtf", dense_from(0),
                                          (1, 0, 0)),
    "forecast_n3dtf dense_from_stage 2": ("forecast_n3dtf", dense_from(2),
                                          (1, 0, 10)),
    "pp_forecast_n3dtf circular_nms": ("pp_forecast_n3dtf", circular_nms,
                                       (0, 7, 0)),
}


def export_case(case):
    from futuredet_torch.config import get_config, tiny_variant
    name, knob, _ = EXPORTS[case]
    cfg = tiny_variant(get_config(name))
    return cfg if knob is None else knob(cfg)


@pytest.fixture(scope="module", params=list(EXPORTS))
def exported(request, tmp_path_factory):
    """tools export --tiny --check on the CPU of the default pillar config
    and of the JAX test's VoxelNet config, and `export_config` of a tiny
    config under a knob: the round trip runs inside the command."""
    out = str(tmp_path_factory.mktemp("export") / "program.pt2")
    name, knob, _ = EXPORTS[request.param]
    if knob is None:
        path = tools.main(["export", "--model", name, "--tiny", "--check",
                           "--device", "cpu", "--out", out])
    else:
        path = tools.export_config(export_case(request.param), out, "cpu",
                                   check=True)
    return request.param, path


def test_export_roundtrip(exported):
    """The artifact loads (the package imported, as here), holds K1, the
    circle NMS and K2 as the registered operators, as many as the program
    runs, and gives the eager program's outputs on a scene of real
    points."""
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.models.detector import build_detector
    case, path = exported
    assert os.path.getsize(path) > 10000
    ep = torch.export.load(path)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    cfg = export_case(case)
    assert tuple(targets.count(f"futuredet.{op}.default") for op in (
        "nms_alive", "circle_nms", "gather_conv")) == EXPORTS[case][2]
    batch = make_batch(cfg, 1, seed=3)
    pts = torch.as_tensor(batch["points"])
    valid = torch.as_tensor(batch["points_valid"])
    assert pts.shape == (1, cfg.voxel.max_points, 5)
    program = tools.inference_program(cfg, build_detector(cfg, "cpu"))
    with torch.no_grad():
        got = ep.module()(pts, valid)
        want = program(pts, valid)
    assert bool(want[3].any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if cfg.model.middle_dense_from_stage is not None:
        # the dense tail's counts, kept on the device in the forward, read
        # as the sparse middle's
        sparse = build_detector(cfg.replace(model=dataclasses.replace(
            cfg.model, middle_dense_from_stage=None)), "cpu")
        with torch.no_grad():
            sparse(pts, valid)
        counts = program.model.backbone.site_counts
        assert counts == sparse.backbone.site_counts and len(counts) == 4
        assert all(type(c) is int for c in counts)

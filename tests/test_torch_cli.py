"""The port's train and evaluate CLIs on the CPU (`--device cpu --tiny`):
checkpoints, per-epoch validation, a non-latest --modelCheckPoint,
--extractBox then --eval_only, the reference CSV, the refused flags, the
real-data flags (--info_path, --db_info_path, --tensorboard) on a
fabricated mini nuScenes, the TensorBoard hook against the JAX package's,
the compact point feeds, and the evaluate CLI against the JAX package's
from the JAX CLI's own seeded init."""
import csv
import dataclasses
import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.data import feed as jax_feed
from futuredet_torch.cli import evaluate, train
from futuredet_torch.data import feed
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

MODEL = "pp_forecast_n3dtf"
# every summary value of the two CLIs on the same detections
SUMMARY_ATOL = 1e-6
# boxes of the two CLIs' detections let off (`match_timestep`) in a run
MAX_LET_OFF = 4
TRAIN_ARGS = ["--model", MODEL, "--tiny", "--device", "cpu",
              "--synthetic", "2", "--epochs", "2", "--val_synthetic", "1"]
EVAL_ARGS = ["--model", MODEL, "--tiny", "--device", "cpu", "--synthetic",
             "3", "--forecast_mode", "velocity_dense", "--cohort_analysis",
             "--K", "5"]


def role_straddle(a, b, thr):
    """The NMS decision between decode boxes a and b differs with the IoU's
    clip roles: the JAX package's XLA NMS clips the victim to the shrunk
    killer, the port's K1 the killer to the grown victim (ROADMAP.md §3,
    clip roles), and the two IoUs lie on both sides of `thr`."""
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev
    ab = np.stack([a, b]).astype(np.float32)
    nb = torch.from_numpy(np.stack([ab[:, 0], ab[:, 1], ab[:, 4], ab[:, 3],
                                    -ab[:, 8] - np.pi / 2], -1))
    iou = pairwise_iou_bev(nb, nb).numpy()
    return min(iou[0, 1], iou[1, 0]) <= thr < max(iou[0, 1], iou[1, 0])


def match_timestep(boxes, scores, jboxes, jscores, post, thr):
    """One timestep's kept boxes of the port against the JAX package's:
    greedy centre matching within 0.1 m, scores within 1e-5 and geometry
    within 1e-4. A box kept by one side only is let off when a box that
    both keep suppresses it under one clip-role order and not the other
    (`role_straddle`), or, in a full timestep, when it lies below the other
    side's lowest kept score (the slot such a box took or freed). Returns
    the boxes let off."""
    used = np.zeros(len(boxes), bool)
    pairs = []
    for j in np.argsort(-jscores, kind="stable"):
        d = np.linalg.norm(boxes[:, :2] - jboxes[j, :2], axis=1)
        d[used] = np.inf
        i = int(np.argmin(d)) if len(d) else -1
        if i >= 0 and d[i] <= 0.1:
            used[i] = True
            pairs.append((i, j))
            assert abs(scores[i] - jscores[j]) <= 1e-5
            np.testing.assert_allclose(boxes[i], jboxes[j], atol=1e-4)
    both = [boxes[i] for i, _ in pairs]
    jmatched = {j for _, j in pairs}
    let_off = []
    for side, bb, ss, mine, other in (
            ("port", boxes, scores, np.nonzero(~used)[0], jscores),
            ("jax", jboxes, jscores,
             [j for j in range(len(jboxes)) if j not in jmatched], scores)):
        for k in mine:
            straddle = any(role_straddle(bb[k], b, thr) for b in both)
            at_cut = len(bb) == post and ss[k] < other.min()
            assert straddle or at_cut, (side, bb[k], ss[k])
            let_off.append({"side": side, "score": float(ss[k]),
                            "straddle": bool(straddle)})
    return let_off


@pytest.mark.parametrize("feed_dtype", feed.FEED_DTYPES)
def test_point_feeds_decode_bit_exactly_as_jax(feed_dtype):
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-60, 60, (2, 500, 3)),
                          rng.uniform(0, 255, (2, 500, 1)),
                          rng.uniform(0, 0.5, (2, 500, 1))], -1)
    pts = pts.astype(np.float32)
    packed = feed.pack_points(pts, feed_dtype)
    jpacked = jax_feed.pack_points(pts, feed_dtype)
    assert packed.dtype == jpacked.dtype
    np.testing.assert_array_equal(packed, jpacked)
    got = feed.unpack_batch({"points": torch.from_numpy(packed),
                             "tokens": ["a"]})
    want = jax_feed.unpack_points(jnp.asarray(jpacked))
    assert got["points"].dtype == torch.float32 and got["tokens"] == ["a"]
    np.testing.assert_array_equal(got["points"].numpy(), np.asarray(want))
    err = np.abs(got["points"].numpy() - pts)[..., :3].max()
    assert err == 0 if feed_dtype == "fp32" else 0 < err <= 2e-3 * 16
    with pytest.raises(ValueError):
        feed.pack_points(pts, "int8")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train CLI, twice one epoch of 2 scenes with validation, into a
    work dir; the log records it wrote."""
    work = tmp_path_factory.mktemp("train")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("futuredet_torch")
    logger.addHandler(handler)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        state = train.main(TRAIN_ARGS + ["--work_dir", str(work)])
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    return work, state, [r.getMessage() for r in records]


def test_train_cli_writes_checkpoints_and_validates(trained):
    work, state, logs = trained
    assert state.step == 4
    assert sorted(os.listdir(work)) == ["step_2.pt", "step_4.pt"]
    vals = [m for m in logs if m.startswith("val @ epoch")]
    assert len(vals) == 2 and "'mAP'" in vals[0] and "'mFAP'" in vals[0]
    from futuredet_torch.train.checkpoints import CheckpointManager
    assert CheckpointManager(str(work)).resolve("epoch_1") == 2


def run_eval(tmp_path, extra, name="m"):
    out = str(tmp_path / f"{name}.json")
    return evaluate.main(EVAL_ARGS + ["--out", out] + extra), out


def test_evaluate_cli_restores_a_non_latest_checkpoint(trained, tmp_path,
                                                       caplog):
    work, _, _ = trained
    caplog.set_level(logging.INFO, logger="futuredet_torch")
    first, _ = run_eval(tmp_path, ["--checkpoint_dir", str(work),
                                   "--modelCheckPoint", "epoch_1"], "e1")
    assert "restored checkpoint step 2 (epoch_1)" in caplog.text
    last, _ = run_eval(tmp_path, ["--checkpoint_dir", str(work)], "last")
    assert "restored checkpoint step 4 (latest)" in caplog.text
    assert first != last
    with pytest.raises(SystemExit, match="modelCheckPoint"):
        run_eval(tmp_path, ["--checkpoint_dir", str(work),
                            "--modelCheckPoint", "epoch_9"])


def test_extract_box_then_eval_only_reproduces_the_summary(trained,
                                                           tmp_path):
    work, _, _ = trained
    pkl = str(tmp_path / "dets.pkl")
    live, out = run_eval(tmp_path, ["--checkpoint_dir", str(work),
                                    "--extractBox", "--predictions_path",
                                    pkl, "--tta", "box"], "live")
    again, _ = run_eval(tmp_path, ["--eval_only", "--predictions_path", pkl,
                                   "--tta", "box"], "again")
    assert again == live
    with open(out) as f:
        assert json.load(f) == live
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    assert len(saved) == 3 and saved[0][2] == ["syn0_0"]
    assert isinstance(saved[0][0].boxes, np.ndarray)
    # the CSV beside the JSON: the reference columns, one row a cohort
    with open(out.replace(".json", ".csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["CLASS", "mAP", "mAR", "mFAP", "mFAR", "mAAP",
                       "mAAR", "ATE", "ASE", "AOE", "AVE", "AAE", "ADE",
                       "FDE", "MR", "mFAP_MR"]
    assert [r[0] for r in rows[1:]] == ["static_car", "linear_car",
                                        "nonlinear_car"]
    assert float(rows[1][1]) == live["mean_dist_aps"]["static_car"]
    assert float(rows[1][12]) == \
        live["label_tp_errors"]["static_car"]["avg_disp_err"]


def test_evaluate_cli_options_run(trained, tmp_path, caplog, monkeypatch):
    """--tta map, --speed_test, int16 feed, prototypes, jitter, rerank,
    nogroup, static_only and the association oracle run through."""
    work, _, _ = trained
    caplog.set_level(logging.INFO, logger="futuredet_torch")
    rng = np.random.default_rng(0)
    protos = [[(rng.normal(0, 3, 2), rng.normal(0, 1, 4))]
              + [rng.normal(0, 2, 3) for _ in range(6)] for _ in range(4)]
    monkeypatch.chdir(tmp_path)
    with open("car_trajectory.pkl", "wb") as f:
        pickle.dump(protos, f)
    s, _ = run_eval(tmp_path, [
        "--checkpoint_dir", str(work), "--tta", "map", "--speed_test",
        "--feed_dtype", "int16", "--postprocess", "--jitter", "--C", "0.5",
        "--rerank", "mult", "--nogroup", "--static_only",
        "--association_oracle"])
    assert "speed test:" in caplog.text
    assert "voxel budget" not in caplog.text      # pillars: no voxelizer
    for v in s["mean_dist_aps"].values():
        assert 0 <= v <= 1


def test_the_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for main, args in ((evaluate.main, EVAL_ARGS), (train.main, TRAIN_ARGS)):
        argv = [a for a in args if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv + ["--out" if main is evaluate.main else "--work_dir",
                         str(tmp_path / "x")])


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_defaults_are_the_jax_clis(cli):
    """parse_args([]) of both packages: the same flags with the same
    defaults (--model forecast_n0, --debug), but for the port's --device
    and one declared difference (ROADMAP.md section 3): the evaluate CLI
    feeds exact fp32 points by default, where the JAX CLI's default int16
    feed was a lever for its TPU host link."""
    import importlib
    jax_cli = importlib.import_module(f"futuredet_tpu.cli.{cli}")
    port_cli = train if cli == "train" else evaluate
    want = vars(jax_cli.parse_args([]))
    got = vars(port_cli.parse_args([]))
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == (set() if cli == "train" else {"feed_dtype"}), differ
    assert got["model"] == "forecast_n0"
    if cli == "train":
        assert port_cli.parse_args(["--debug"]).debug


def load_reference_two_stage(argv):
    """A reference two-stage .pth, whose keys the port does not map."""
    from futuredet_torch.config import get_config
    from futuredet_torch.utils.convert_checkpoint import \
        load_reference_state_dict
    load_reference_state_dict(*argv, get_config("forecast_n3dtf_two_stage"))


@pytest.mark.parametrize("main,extra,item", [
    (load_reference_two_stage, ["reference.pth"], "long tail"),
])
def test_unported_flags_raise_naming_their_roadmap_item(main, extra, item):
    base = {evaluate.main: EVAL_ARGS, train.main: TRAIN_ARGS}.get(main, [])
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        main(base + extra)


@pytest.mark.parametrize("model", ["forecast_n3dtf_two_stage",
                                   "pp_forecast_n3dtf_two_stage",
                                   "forecast_n0 + dcn_head"])
@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_space_takes_every_config(cli, model, monkeypatch):
    """--space 2 of a two-stage config or of dcn_head passes the layout
    and fails, in a process of one rank, only for want of its ranks
    (tests/test_torch_cli_spatial.py::
    test_space_without_its_ranks_fails_loudly)."""
    import dataclasses

    from futuredet_torch import config as port_config
    name = model.split()[0]
    if model.endswith("dcn_head"):
        get = port_config.get_config

        def with_dcn(n):
            cfg = get(n)
            return cfg.replace(model=dataclasses.replace(
                cfg.model, head=dataclasses.replace(cfg.model.head,
                                                    dcn_head=True)))
        monkeypatch.setattr(port_config, "get_config", with_dcn)
    main, base = ((train.main, TRAIN_ARGS) if cli == "train"
                  else (evaluate.main, EVAL_ARGS))
    with pytest.raises(ValueError, match="--space 2 does not divide the "
                                         "world size 1"):
        main(base + ["--model", name, "--space", "2"])


def mini_dataset(root, n_samples=2, model=MODEL):
    """A mini nuScenes (`tests/test_infos.py::_mk_mini_nusc`: one train
    and one val scene of `n_samples` keyframes, 3 sweeps) prepared by the
    port's create_data CLI with the GT database. Returns the train and
    val infos pkls and the dbinfos pkl."""
    from futuredet_torch.cli import create_data
    from tests.test_infos import _mk_mini_nusc

    version = _mk_mini_nusc(root, n_samples=n_samples,
                            scene_names=("scene-0061", "scene-0103"))
    tr, va = create_data.main([
        "nuscenes_data_prep", "--root_path", str(root), "--version",
        version, "--nsweeps", "3", "--gt_database", "--model", model])
    return tr, va, str(root / "dbinfos_train_3sweeps_withvelo.pkl")


@pytest.fixture(scope="module")
def real_data(tmp_path_factory):
    return mini_dataset(tmp_path_factory.mktemp("nusc"))


def read_scalars(log_dir):
    """{tag: [(step, value)]} of the TensorBoard event files in log_dir."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.mark.parametrize("flag", ["evaluate --info_path",
                                  "train --info_path", "train --db_info_path",
                                  "train --tensorboard"])
def test_ported_data_flags_run(real_data, tmp_path, caplog, monkeypatch,
                               flag):
    """The flags the port once refused run: evaluation and training of
    the tiny model on the mini dataset's infos, GT-AUG from a dbinfos pkl
    named by --db_info_path (with --no_gt_aug, none), and TensorBoard
    scalars written under {work_dir}/tb."""
    tr, va, db = real_data
    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.INFO, logger="futuredet_torch")
    base = ["--model", MODEL, "--tiny", "--device", "cpu"]
    work = tmp_path / "work"
    if flag == "evaluate --info_path":
        s = evaluate.main(base + ["--info_path", va, "--forecast_mode",
                                  "velocity_dense", "--out",
                                  str(tmp_path / "m.json")])
        assert 0 <= s["mean_dist_aps"]["car"] <= 1
        assert (tmp_path / "m.csv").exists()
        return
    argv = base + ["--info_path", tr, "--epochs", "1", "--work_dir",
                   str(work)]
    if flag == "train --db_info_path":
        state = train.main(argv + ["--db_info_path", db])
        assert "GT-AUG enabled" in caplog.text
        caplog.clear()
        train.main(argv + ["--db_info_path", db, "--no_gt_aug"])
        assert "GT-AUG" not in caplog.text
    elif flag == "train --tensorboard":
        state = train.main(argv + ["--tensorboard"])
        scalars = read_scalars(work / "tb")
        assert set(scalars) == {"train/loss", "train/grad_norm"}
        assert [st for st, _ in scalars["train/loss"]] == [state.step]
    else:
        # the config's 20-sweep dbinfos name is not there: no GT-AUG
        state = train.main(argv)
        assert "GT-AUG disabled: no dbinfos" in caplog.text
    assert state.step == 2
    assert "step_2.pt" in os.listdir(work)


def test_tensorboard_hook_writes_the_jax_hooks_scalars(tmp_path, caplog):
    """The same metrics through both hooks (interval 2, five steps): the
    same tags, steps and values read back from the event files, the
    partial last window included. Without torch.utils.tensorboard the
    port's hook warns once and logs nothing."""
    import builtins

    from futuredet_torch.train.trainer import TensorBoardHook
    from futuredet_tpu.train.trainer import \
        TensorBoardHook as JaxTensorBoardHook

    rng = np.random.default_rng(0)
    steps = [{"loss": float(rng.uniform(1, 2)),
              "grad_norm": float(rng.uniform(0, 5)),
              "hm_loss": rng.uniform(0, 1, 7).astype(np.float32)}
             for _ in range(5)]
    hook = TensorBoardHook(str(tmp_path / "port"), interval=2)
    jhook = JaxTensorBoardHook(str(tmp_path / "jax"), interval=2)
    for i, m in enumerate(steps):
        hook.after_step(i, None, {k: torch.tensor(v) for k, v in m.items()})
        jhook.after_step(i, None, {k: jnp.asarray(v) for k, v in m.items()})
    hook.after_train(None)
    jhook.after_train(None)
    got, want = read_scalars(tmp_path / "port"), read_scalars(
        tmp_path / "jax")
    assert set(got) == {"train/loss", "train/grad_norm"}
    assert got == want
    assert [st for st, _ in got["train/loss"]] == [2, 4, 5]

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if "tensorboard" in name:
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *a, **kw)

    caplog.set_level(logging.WARNING, logger="futuredet_torch")
    builtins.__import__ = no_tensorboard
    try:
        off = TensorBoardHook(str(tmp_path / "off"), interval=1)
    finally:
        builtins.__import__ = real_import
    assert off.writer is None
    assert caplog.text.count("TB logging disabled") == 1
    off.after_step(0, None, {"loss": torch.tensor(1.0)})
    off.after_train(None)
    assert not (tmp_path / "off").exists()


def test_train_config_keeps_every_field():
    """The flags rebuild TrainConfig by dataclasses.replace: the fields
    they do not name keep their values (the JAX CLI's rebuild drops
    batch_size_per_device, ADVICE.md)."""
    from futuredet_torch.config import get_config
    cfg = get_config(MODEL)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size_per_device=3, log_interval=7))
    args = train.parse_args(["--epochs", "4", "--checkpoint_interval", "2",
                             "--seed", "5", "--autoscale_lr"])
    tc = train.train_config(cfg, args).train
    assert (tc.total_epochs, tc.checkpoint_interval_epochs, tc.seed) == \
        (4, 2, 5)
    assert (tc.batch_size_per_device, tc.log_interval) == (3, 7)
    assert tc.optim == cfg.train.optim
    assert train.train_config(cfg, train.parse_args([])) == cfg


def test_without_a_checkpoint_the_seeded_init_is_evaluated(tmp_path,
                                                           caplog):
    caplog.set_level(logging.INFO, logger="futuredet_torch")
    run_eval(tmp_path, ["--checkpoint_dir", str(tmp_path / "none")])
    assert "evaluating the seeded init" in caplog.text
    with pytest.raises(SystemExit, match="no dataset"):
        evaluate.main(["--model", MODEL, "--tiny", "--device", "cpu"])


def compare_with_the_jax_cli(model_name, extra, per_slice):
    """The JAX CLI's seeded init (PRNGKey(0) on its first batch), carried
    across by flax_to_state_dict into a port checkpoint, then both CLIs on
    the same tiny synthetic scenes with the fp32 feed and `extra` flags, in
    the current directory. Detections compared per pseudo-task slice
    (`match_timestep`'s let-off; with `per_slice` labels too), every
    summary value within 1e-6. Returns the port's summary."""
    from futuredet_tpu.cli import evaluate as jax_evaluate
    from futuredet_tpu.config import get_config as jax_get_config
    from futuredet_tpu.config import tiny_variant as jax_tiny_variant
    from futuredet_tpu.data.synthetic import make_batch as jax_make_batch
    from futuredet_tpu.train.step import init_state
    from futuredet_torch.config import get_config, tiny_variant
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.checkpoints import CheckpointManager
    from futuredet_torch.train.step import make_optimizer
    from futuredet_torch.utils.convert_checkpoint import flax_to_state_dict

    cfg_j = jax_tiny_variant(jax_get_config(model_name))
    first = jax_make_batch(cfg_j, 1, seed=0, clutter_mode="lidar")
    first = {k: v for k, v in first.items()
             if k in ("points", "points_valid", "targets", "bev_map")}
    state = init_state(cfg_j, jax.random.PRNGKey(0),
                       jax.tree.map(lambda x: x[:1], first), total_steps=1)
    cfg = tiny_variant(get_config(model_name))
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(
        jax.device_get({"params": state.params,
                        "batch_stats": state.batch_stats}), cfg),
        strict=True)
    CheckpointManager("port_ckpt").save(1, model,
                                        make_optimizer(cfg, model, 1))

    common = ["--model", model_name, "--tiny", "--synthetic", "2",
              "--feed_dtype", "fp32", "--K", "5", "--extractBox"] + extra
    want = jax_evaluate.main(common + [
        "--checkpoint_dir", "no_jax_ckpt", "--predictions_path", "j.pkl",
        "--out", "j.json"])
    got = evaluate.main(common + [
        "--device", "cpu", "--checkpoint_dir", "port_ckpt",
        "--predictions_path", "p.pkl", "--out", "p.json"])

    with open("j.pkl", "rb") as f:
        jsaved = pickle.load(f)
    with open("p.pkl", "rb") as f:
        psaved = pickle.load(f)
    post = cfg.test.nms.post_max_size
    thr = cfg.test.nms.iou_threshold
    n, let_off = 0, []
    for (det, _, tok), (jdet, _, jtok) in zip(psaved, jsaved):
        assert tok == jtok
        for t in range(det.valid.shape[1] // post):
            sl = slice(t * post, (t + 1) * post)
            keep = det.valid[0, sl]
            jkeep = np.asarray(jdet.valid[0, sl])
            assert keep.sum() == jkeep.sum()
            n += int(keep.sum())
            off = match_timestep(
                det.boxes[0, sl][keep], det.scores[0, sl][keep],
                np.asarray(jdet.boxes[0, sl])[jkeep],
                np.asarray(jdet.scores[0, sl])[jkeep], post, thr)
            if per_slice and not off:
                np.testing.assert_array_equal(
                    np.sort(det.labels[0, sl][keep]),
                    np.sort(np.asarray(jdet.labels[0, sl])[jkeep]))
            let_off += off
    assert n > 50 and len(let_off) <= MAX_LET_OFF, let_off

    def flat(d, path=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", v
    got_flat, want_flat = dict(flat(got)), dict(flat(want))
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        assert abs(got_flat[k] - v) <= SUMMARY_ATOL, (k, got_flat[k], v)
    assert any(v not in (0.0, 1.0) for v in want_flat.values())
    return got


def test_evaluate_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """pp_forecast_n3dtf with velocity_dense linking and cohorts: the same
    detections timestep by timestep and every summary value within
    1e-6."""
    monkeypatch.chdir(tmp_path)
    compare_with_the_jax_cli(MODEL, ["--forecast_mode", "velocity_dense",
                                     "--cohort_analysis"], False)


def test_multitask_evaluate_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """pp_centerpoint_multitask: six class groups decoded with global
    class ids, class-labeled detection metrics over the ten class names,
    the same as the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    got = compare_with_the_jax_cli("pp_centerpoint_multitask", [], True)
    from futuredet_torch.config import get_config
    assert list(got["mean_dist_aps"]) == list(
        get_config("pp_centerpoint_multitask").data.class_names)


@pytest.mark.parametrize("model,extra", [
    ("forecast_n0", ["--forecast_mode", "velocity_constant"]),
    ("centerpoint_multitask", []),
    ("forecast_n3dtfm", ["--forecast_mode", "velocity_dense"])])
def test_head_mode_evaluate_cli_runs(tmp_path, model, extra, caplog):
    """The evaluate CLI on VoxelNet head modes: forecast_n0 (one vel map
    replicated into 7 pseudo-timesteps, linked at constant velocity),
    centerpoint_multitask (class-labeled metrics JSON and CSV) and
    forecast_n3dtfm (the synthetic scenes' ego maps fed); --tta on a
    bev_map config is refused."""
    caplog.set_level(logging.INFO, logger="futuredet_torch")
    out = str(tmp_path / "m.json")
    argv = ["--model", model, "--tiny", "--device", "cpu", "--synthetic",
            "2", "--out", out] + extra
    summary = evaluate.main(argv)
    with open(out) as f:
        assert json.load(f) == summary
    classes = list(summary["mean_dist_aps"])
    if model == "centerpoint_multitask":
        assert len(classes) == 10 and classes[0] == "car"
        with open(out.replace(".json", ".csv")) as f:
            assert [r[0] for r in csv.reader(f)][1:] == classes
    else:
        assert classes == ["car"]
    for v in summary["mean_dist_aps"].values():
        assert 0 <= v <= 1
    assert "voxel budget" in caplog.text
    if model == "forecast_n3dtfm":
        with pytest.raises(SystemExit, match="bev_map"):
            evaluate.main(argv + ["--tta", "map"])


TWO_STAGE = "pp_forecast_n3dtf_two_stage"


def test_two_stage_evaluate_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """pp_forecast_n3dtf_two_stage: the RoI head's refined detections
    (refined boxes, fused scores, the first stage's labels) the same as the
    JAX CLI's per pseudo-task slice, and every summary value within 1e-6;
    --tta on a two-stage config is refused, as the JAX CLI refuses it."""
    monkeypatch.chdir(tmp_path)
    compare_with_the_jax_cli(TWO_STAGE, ["--forecast_mode",
                                         "velocity_dense"], True)
    with pytest.raises(SystemExit, match="two-stage"):
        evaluate.main(["--model", TWO_STAGE, "--tiny", "--device", "cpu",
                       "--synthetic", "1", "--tta", "map"])


def test_two_stage_train_cli_grafts_a_first_stage_and_resumes(tmp_path,
                                                              caplog):
    """cli.train of a tiny single-stage pp_forecast_n3dtf, then of its
    two-stage config with --first_stage_checkpoint: the first stage starts
    from the single-stage checkpoint (the two-stage convs and the RoI head
    from their init), only the trainable subset moves, the refined
    detections are validated, and a resume continues from the last
    checkpoint with the optimizer's state of the subset."""
    from futuredet_torch.models.two_stage import two_stage_trainable_mask
    from futuredet_torch.train.checkpoints import CheckpointManager

    caplog.set_level(logging.INFO, logger="futuredet_torch")
    single = str(tmp_path / "single")
    train.main(["--model", MODEL, "--tiny", "--device", "cpu",
                "--synthetic", "2", "--epochs", "1", "--work_dir", single])
    first = torch.load(os.path.join(single, "step_2.pt"),
                       weights_only=True)["model"]
    work = str(tmp_path / "two")
    argv = ["--model", TWO_STAGE, "--tiny", "--device", "cpu",
            "--synthetic", "2", "--epochs", "1", "--val_synthetic", "1",
            "--work_dir", work, "--first_stage_checkpoint", single]
    state = train.main(argv)
    assert f"grafted first-stage checkpoint step 2 from {single}" \
        in caplog.text
    assert [m for m in caplog.messages if m.startswith("val @ epoch")]
    mask = two_stage_trainable_mask(state.model)
    after = state.model.state_dict()
    for k, v in first.items():
        key = "first_stage." + k
        if key in mask or k.endswith("num_batches_tracked") \
                or "running_" in k:
            continue
        assert torch.equal(after[key], v), key
    assert sorted(os.listdir(work)) == ["step_2.pt"]
    saved = torch.load(os.path.join(work, "step_2.pt"), weights_only=True)
    assert len(saved["optimizer"]["param_groups"][0]["params"]) == 92
    # the subset's optimizer state round-trips exactly
    from futuredet_torch.config import get_config, tiny_variant
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import make_optimizer
    cfg = tiny_variant(get_config(TWO_STAGE))
    model = build_detector(cfg, device="cpu")
    opt = make_optimizer(cfg, model, 2)
    assert CheckpointManager(work).restore(model, opt) == 2
    got = opt.state_dict()["state"]
    assert len(got) == 92 and got.keys() == saved["optimizer"]["state"].keys()
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got[i][k], v), (i, k)

    # resume: one more epoch from step 2, the subset's optimizer restored
    state2 = train.main(argv[:-2] + ["--epochs", "2", "--resume_from"])
    assert "resumed from step 2" in caplog.text
    assert state2.step == 4
    assert CheckpointManager(work).all_steps() == [2, 4]
    with pytest.raises(SystemExit, match="_two_stage"):
        train.main(["--model", MODEL, "--tiny", "--device", "cpu",
                    "--synthetic", "2", "--first_stage_checkpoint", single])

"""The port's train and evaluate CLIs on the CPU (`--device cpu --tiny`):
checkpoints, per-epoch validation, a non-latest --modelCheckPoint,
--extractBox then --eval_only, the reference CSV, the refused flags, the
compact point feeds, and the evaluate CLI against the JAX package's from
the JAX CLI's own seeded init."""
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


@pytest.mark.parametrize("main,extra,item", [
    (evaluate.main, ["--info_path", "infos.pkl"], "the data pipeline"),
    (evaluate.main, ["--space", "2"], "DDP"),
    (evaluate.main, ["--coordinator_address", "localhost:1",
                     "--num_processes", "2"], "DDP"),
    (evaluate.main, ["--model", "pp_forecast_n3dtf_two_stage"], "long tail"),
    (train.main, ["--info_path", "infos.pkl"], "the data pipeline"),
    (train.main, ["--db_info_path", "db.pkl"], "the data pipeline"),
    (train.main, ["--first_stage_checkpoint", "w"], "long tail"),
    (train.main, ["--model", "forecast_n3dtf_two_stage"], "long tail"),
    (train.main, ["--tensorboard"], "the trainer's extras"),
    (train.main, ["--profile", "trace"], "long tail"),
    (train.main, ["--space", "2"], "DDP"),
    (train.main, ["--num_processes", "4", "--process_id", "1"], "DDP"),
])
def test_unported_flags_raise_naming_their_roadmap_item(main, extra, item):
    base = EVAL_ARGS if main is evaluate.main else TRAIN_ARGS
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        main(base + extra)


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


def test_evaluate_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """The JAX CLI's seeded init (PRNGKey(0) on its first batch), carried
    across by flax_to_state_dict into a port checkpoint: both CLIs on the
    same synthetic scenes with the fp32 feed give the same detections,
    timestep by timestep (`match_timestep`'s let-off), and every summary
    value within 1e-6."""
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

    monkeypatch.chdir(tmp_path)
    cfg_j = jax_tiny_variant(jax_get_config(MODEL))
    first = jax_make_batch(cfg_j, 1, seed=0, clutter_mode="lidar")
    first = {k: v for k, v in first.items()
             if k in ("points", "points_valid", "targets", "bev_map")}
    state = init_state(cfg_j, jax.random.PRNGKey(0),
                       jax.tree.map(lambda x: x[:1], first), total_steps=1)
    cfg = tiny_variant(get_config(MODEL))
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(
        jax.device_get({"params": state.params,
                        "batch_stats": state.batch_stats}), cfg),
        strict=True)
    CheckpointManager("port_ckpt").save(1, model,
                                        make_optimizer(cfg, model, 1))

    common = ["--model", MODEL, "--tiny", "--synthetic", "2",
              "--feed_dtype", "fp32", "--forecast_mode", "velocity_dense",
              "--cohort_analysis", "--K", "5", "--extractBox"]
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
        for t in range(cfg.model.head.timesteps):
            sl = slice(t * post, (t + 1) * post)
            keep = det.valid[0, sl]
            jkeep = np.asarray(jdet.valid[0, sl])
            assert keep.sum() == jkeep.sum()
            n += int(keep.sum())
            let_off += match_timestep(
                det.boxes[0, sl][keep], det.scores[0, sl][keep],
                np.asarray(jdet.boxes[0, sl])[jkeep],
                np.asarray(jdet.scores[0, sl])[jkeep], post, thr)
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

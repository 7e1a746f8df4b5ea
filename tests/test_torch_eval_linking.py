"""The port's linking, serialization and evaluator against the JAX
package's, on the same seeded per-timestep detections: every forecast
mode, re-ranking, multi-future grouping, jitter, prototype snapping, the
submission JSON, `evaluate_detections` on the same Detections, the
multitask trio on constructed detections, and the GT-as-predictions
oracle."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.config import get_config as jax_get_config
from futuredet_tpu.config import tiny_variant as jax_tiny_variant
from futuredet_tpu.eval import evaluator as jax_evaluator
from futuredet_tpu.eval import linking as jax_linking
from futuredet_tpu.eval import serialize as jax_serialize
from futuredet_tpu.eval.decode import Detections as JaxDetections
from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.eval import evaluator, linking, serialize
from futuredet_torch.eval.decode import Detections

T = 7
BOX_ATOL = 1e-6
SUMMARY_ATOL = 1e-6
MODES = ("velocity_constant", "velocity_forward", "velocity_reverse",
         "velocity_dense")


def scene_detections(seed, n_obj=14, n_fp=6, B=1, slots=40):
    """Per sample, objects moving at constant velocity seen at every
    timestep with position noise, plus false positives; labels are the
    timestep; some slots invalid. Arrays (B, T * slots, ...)."""
    rng = np.random.default_rng(seed)
    N = T * slots
    boxes = np.zeros((B, N, 9), np.float32)
    scores = np.zeros((B, N), np.float32)
    labels = np.zeros((B, N), np.int32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        start = rng.uniform(-40, 40, (n_obj, 2))
        vel = rng.uniform(-6, 6, (n_obj, 2)) * (rng.random((n_obj, 1)) < 0.7)
        # objects 0 and 1 stay 0.14 m apart: a multi-future group
        size = rng.uniform(0.6, 4.5, (n_obj, 3))
        yaw = rng.uniform(-np.pi, np.pi, n_obj)
        for t in range(T):
            k = t * slots
            c = start + 0.5 * t * vel + rng.normal(0, 0.15, (n_obj, 2))
            c[1] = c[0] + 0.1
            rows = np.concatenate([
                c, rng.uniform(-1, 1, (n_obj, 1)), size,
                vel + rng.normal(0, 0.3, (n_obj, 2)), yaw[:, None]], 1)
            fp = np.concatenate([
                rng.uniform(-45, 45, (n_fp, 2)), rng.uniform(-1, 1, (n_fp, 1)),
                rng.uniform(0.5, 4, (n_fp, 3)), rng.uniform(-5, 5, (n_fp, 2)),
                rng.uniform(-3, 3, (n_fp, 1))], 1)
            m = n_obj + n_fp
            boxes[b, k:k + m] = np.concatenate([rows, fp])
            scores[b, k:k + m] = rng.uniform(0.1, 1.0, m)
            labels[b, k:k + slots] = t
            valid[b, k:k + m] = True
            valid[b, k + m - 2] = False
    return boxes, scores, labels, valid


def per_t(mod, seed, b=0, **kw):
    boxes, scores, labels, valid = scene_detections(seed, **kw)
    return mod.split_by_timestep(boxes[b], scores[b], labels[b], valid[b], T)


def assert_same_trajectories(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):      # order identical
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=0, atol=BOX_ATOL)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert g.det_score == w.det_score
        assert g.forecast_id == w.forecast_id


TIMES = [0.5, 0.5, 0.45, 0.55, 0.5, 0.5]


@pytest.mark.parametrize("classname", ["car", "pedestrian"])
@pytest.mark.parametrize("mode", MODES)
def test_link_sample_matches_jax(mode, classname):
    got = linking.link_sample(classname, mode, TIMES, per_t(linking, 0))
    want = jax_linking.link_sample(classname, mode, TIMES,
                                   per_t(jax_linking, 0))
    assert_same_trajectories(got, want)
    # multi-future grouping on top
    assert_same_trajectories(linking.multi_future(got),
                             jax_linking.multi_future(want))
    if mode != "velocity_reverse":   # its boxes[0] is the extrapolated end
        assert len({t.forecast_id for t in got}) < len(got)


def test_tracker_edge_cases_match_jax():
    """An empty timestep aborts the tracker; other classes link nothing;
    velocity_sparse is refused by both."""
    p, jp = per_t(linking, 1), per_t(jax_linking, 1)
    p[3] = (p[3][0][:0], p[3][1][:0])
    jp[3] = (jp[3][0][:0], jp[3][1][:0])
    assert linking.tracker("car", TIMES, p) == [] \
        == jax_linking.tracker("car", TIMES, jp)
    assert linking.tracker("truck", TIMES, per_t(linking, 1)) == []
    assert_same_trajectories(linking.match_boxes(p),
                             jax_linking.match_boxes(jp))
    for mod in (linking, jax_linking):
        with pytest.raises(ValueError, match="dead code"):
            mod.link_sample("car", "velocity_sparse_forward", TIMES, p)
        with pytest.raises(ValueError, match="unknown"):
            mod.link_sample("car", "nope", TIMES, p)


@pytest.mark.parametrize("rerank", ["first", "last", "add", "mult"])
def test_trajectory_score_matches_jax(rerank):
    got = linking.link_sample("car", "velocity_dense", TIMES,
                              per_t(linking, 2))
    want = jax_linking.link_sample("car", "velocity_dense", TIMES,
                                   per_t(jax_linking, 2))
    assert [linking.trajectory_score(t, rerank, T) for t in got] == \
        [jax_linking.trajectory_score(t, rerank, T) for t in want]


def test_jitter_and_prototypes_match_jax():
    got = linking.multi_future(linking.link_sample(
        "car", "velocity_forward", TIMES, per_t(linking, 3)))
    want = jax_linking.multi_future(jax_linking.link_sample(
        "car", "velocity_forward", TIMES, per_t(jax_linking, 3)))
    assert_same_trajectories(
        linking.jitter_trajectories(got, TIMES, 5, 0.7),
        jax_linking.jitter_trajectories(want, TIMES, 5, 0.7))
    rng = np.random.default_rng(4)
    protos = [[(rng.normal(0, 3, 2), rng.normal(0, 1, 4))]
              + [rng.normal(0, 2, 3) for _ in range(T - 1)]
              for _ in range(9)]
    assert_same_trajectories(linking.snap_to_prototypes(got, protos),
                             jax_linking.snap_to_prototypes(want, protos))
    short = [p[:3] for p in protos]
    for mod, tr in ((linking, got), (jax_linking, want)):
        with pytest.raises(ValueError, match="different horizon"):
            mod.snap_to_prototypes(tr, short)


def test_submission_json_matches_jax(tmp_path):
    trajs = linking.multi_future(linking.link_sample(
        "car", "velocity_dense", TIMES, per_t(linking, 5)))
    jtrajs = jax_linking.multi_future(jax_linking.link_sample(
        "car", "velocity_dense", TIMES, per_t(jax_linking, 5)))
    tokens = [f"tok{t}" for t in range(T)]
    ours = {"s0": [serialize.serialize_trajectory(
        t, tokens, "car", linking.trajectory_score(t, "mult", T))
        for t in trajs]}
    theirs = {"s0": [jax_serialize.serialize_trajectory(
        t, tokens, "car", jax_linking.trajectory_score(t, "mult", T))
        for t in jtrajs]}
    serialize.write_submission(str(tmp_path / "a.json"), ours)
    jax_serialize.write_submission(str(tmp_path / "b.json"), theirs)
    a = (tmp_path / "a.json").read_text()
    assert a == (tmp_path / "b.json").read_text()
    doc = json.loads(a)
    assert len(doc["results"]["s0"]) == len(trajs)
    for name, speed in (("bus", 0.0), ("bicycle", 3.0), ("pedestrian", 0.1),
                        ("barrier", 1.0)):
        assert serialize._attr_for(name, speed) == \
            jax_serialize._attr_for(name, speed)
        assert evaluator.pred_attribute(name, speed) == \
            jax_evaluator.pred_attribute(name, speed)


def both_detections(seed, B=2):
    arrays = scene_detections(seed, B=B)
    return (Detections(*(torch.from_numpy(a) for a in arrays)),
            JaxDetections(*(jnp.asarray(a) for a in arrays)))


def tiny_cfgs(name="pp_forecast_n3dtf"):
    return (tiny_variant(get_config(name)),
            jax_tiny_variant(jax_get_config(name)))


def gt_of_detections(seed, B=2):
    """A GT dict whose trajectories are the scene's objects (timestep t's
    first rows), in the info layout (B, T, M, 12)."""
    boxes, _, labels, valid = scene_detections(seed, B=B)
    M = 14
    gt = np.zeros((B, T, M, 12), np.float32)
    for t in range(T):
        rows = boxes[:, t * 40:t * 40 + M]
        gt[:, t, :, :8] = rows[..., :8]
        gt[:, t, :, 10] = -rows[..., 8] - np.pi / 2
    rng = np.random.default_rng(seed)
    return {"boxes": gt, "valid": np.ones((B, T, M), bool),
            "traj": rng.integers(1, 4, (B, M)),
            "classes": np.ones((B, T, M), np.int32)}


@pytest.mark.parametrize("kw", [
    dict(forecast_mode="velocity_dense", cohort_analysis=True, topk=5),
    dict(forecast_mode="velocity_forward", rerank="add", nogroup=True),
    dict(forecast_mode="velocity_reverse", association_oracle=True,
         static_only=True),
    dict(forecast_mode="velocity_constant", jitter=True, topk=3,
         jitter_C=0.5, tp_pct=0.8),
])
def test_evaluate_detections_matches_jax(kw):
    cfg, cfg_j = tiny_cfgs()
    det, jdet = both_detections(6)
    gt = gt_of_detections(6)
    tokens = ["a", "b"]
    got = evaluator.evaluate_detections(cfg, det, gt, tokens, **kw).summary()
    want = jax_evaluator.evaluate_detections(cfg_j, jdet, gt, tokens,
                                             **kw).summary()
    _assert_summary(got, want)
    assert max(got["mean_dist_aps"].values()) > 0


def _assert_summary(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_summary(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=SUMMARY_ATOL,
                                       err_msg=k)


def test_detections_to_predictions_matches_jax():
    """Records field by field, with per-sample keyframe gaps and prototype
    snapping."""
    cfg, cfg_j = tiny_cfgs()
    det, jdet = both_detections(7)
    rng = np.random.default_rng(7)
    protos = [[(rng.normal(0, 3, 2), rng.normal(0, 1, 4))]
              + [rng.normal(0, 2, 3) for _ in range(T - 1)]
              for _ in range(5)]
    times = [TIMES, [0.5] * 3]       # the second is ignored: wrong length
    kw = dict(forecast_mode="velocity_dense", rerank="mult",
              prototypes=protos, sample_times=times)
    got = evaluator.detections_to_predictions(cfg, det, ["a", "b"], **kw)
    want = jax_evaluator.detections_to_predictions(cfg_j, jdet, ["a", "b"],
                                                   **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in ("sample", "yaw", "det_score", "forecast_score",
                  "forecast_id", "classname", "attr"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), abs=1e-6)
        for f in ("centers", "size", "vel"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=0, atol=BOX_ATOL)


def multitask_detections(cfg, seed, B=2, N=60):
    """Class-labelled detections as a multitask decode gives them."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([
        rng.uniform(-40, 40, (B, N, 2)), rng.uniform(-1, 1, (B, N, 1)),
        rng.uniform(0.5, 4, (B, N, 3)), rng.uniform(-4, 4, (B, N, 2)),
        rng.uniform(-3, 3, (B, N, 1))], -1).astype(np.float32)
    scores = rng.uniform(0.1, 1, (B, N)).astype(np.float32)
    labels = rng.integers(0, len(cfg.data.class_names), (B, N)).astype(
        np.int32)
    valid = rng.random((B, N)) < 0.9
    gt = np.zeros((B, T, N, 12), np.float32)
    gt[:, 0, :, :8] = boxes[..., :8] + np.concatenate(
        [rng.normal(0, 0.3, (B, N, 2)), np.zeros((B, N, 6))], -1)
    gt[:, 0, :, 10] = -boxes[..., 8] - np.pi / 2
    classes = np.zeros((B, T, N), np.int32)
    classes[:, 0] = np.where(rng.random((B, N)) < 0.8, labels + 1,
                             rng.integers(1, 11, (B, N)))
    classes[:, 0, :3] = 0                      # invalid class ids
    gvalid = np.zeros((B, T, N), bool)
    gvalid[:, 0] = rng.random((B, N)) < 0.85
    return (boxes, scores, labels, valid), {"boxes": gt, "valid": gvalid,
                                            "classes": classes}


def test_multitask_trio_matches_jax():
    cfg, cfg_j = tiny_cfgs("centerpoint_multitask")
    arrays, gt = multitask_detections(cfg, 8)
    det = Detections(*(torch.from_numpy(a) for a in arrays))
    jdet = JaxDetections(*(jnp.asarray(a) for a in arrays))
    tokens = ["a", "b"]
    got = evaluator.multitask_detection_records(cfg, det, tokens)
    want = jax_evaluator.multitask_detection_records(cfg_j, jdet, tokens)
    assert [(p.classname, p.det_score, p.attr) for p in got] == \
        [(p.classname, p.det_score, p.attr) for p in want]
    g = evaluator.gt_records_multiclass(gt["boxes"], gt["valid"],
                                        gt["classes"], tokens,
                                        cfg.data.class_names)
    jg = jax_evaluator.gt_records_multiclass(gt["boxes"], gt["valid"],
                                             gt["classes"], tokens,
                                             cfg_j.data.class_names)
    assert [(r.sample, r.classname, r.yaw) for r in g] == \
        [(r.sample, r.classname, r.yaw) for r in jg]
    res = evaluator.evaluate_detections_multitask(cfg, det, gt, tokens,
                                                  topk=2).summary()
    jres = jax_evaluator.evaluate_detections_multitask(
        cfg_j, jdet, gt, tokens, topk=2).summary()
    _assert_summary(res, jres)
    assert len(res["mean_dist_aps"]) == 10
    assert max(res["mean_dist_aps"].values()) > 0.3


def test_forecast_linking_refuses_multitask_configs():
    cfg, _ = tiny_cfgs("centerpoint_multitask")
    det, _ = both_detections(9)
    with pytest.raises(NotImplementedError, match="multi-task"):
        evaluator.detections_to_predictions(cfg, det, ["a", "b"])


def test_gt_as_predictions_oracle():
    """Feeding the GT back as detections gives near-perfect metrics through
    the whole linking + metric path (tests/test_e2e_eval.py's oracle)."""
    cfg = tiny_variant(get_config("forecast_n3dtf"))
    batch = make_batch(cfg, 2, seed=5, n_objects=5, n_clutter=100,
                       max_objs=16)
    gt = batch["gt"]
    post = cfg.test.nms.post_max_size
    B, N = 2, T * post
    boxes = np.zeros((B, N, 9), np.float32)
    scores = np.zeros((B, N), np.float32)
    labels = np.zeros((B, N), np.int32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        i = 0
        for t in range(T):
            for k in range(16):
                if not gt["valid"][b][t, k]:
                    continue
                g = gt["boxes"][b][t, k]
                boxes[b, i] = [*g[:8], g[10]]
                scores[b, i], labels[b, i], valid[b, i] = 0.9, t, True
                i += 1
    det = Detections(*(torch.from_numpy(a) for a in
                       (boxes, scores, labels, valid)))
    res = evaluator.evaluate_detections(cfg, det, gt, ["s0", "s1"],
                                        forecast_mode="velocity_dense")
    assert res.mean_dist_aps["car"] > 0.9, res.mean_dist_aps
    assert res.mean_dist_faps["car"] > 0.9, res.mean_dist_faps
    assert res.label_tp_errors["car"]["avg_disp_err"] < 0.5
    res_c = evaluator.evaluate_detections(cfg, det, gt, ["s0", "s1"],
                                          forecast_mode="velocity_dense",
                                          cohort_analysis=True)
    assert set(res_c.mean_dist_aps) == {"static_car", "linear_car",
                                        "nonlinear_car"}

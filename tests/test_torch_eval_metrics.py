"""The port's metric engine against the JAX package's: the golden fixture
on both matchers, seeded random record sets, the C++ matcher against the
numpy one, and trajectory classification."""
import json
import os

import numpy as np
import pytest

from futuredet_tpu.core import trajectory as jax_trajectory
from futuredet_tpu.eval import metrics as JM
from futuredet_torch.core import trajectory
from futuredet_torch.eval import metrics as M
from futuredet_torch.ops import _build
from futuredet_torch.utils import native

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# the C++ matcher accumulates fp32 distances where numpy uses fp64 (the
# tolerance of tests/test_metrics_golden.py)
GOLDEN_ATOL = 2e-6
# the same numpy code on the same records: equal up to summation order
NUMPY_ATOL = 1e-12
SETTINGS = {
    "plain": dict(tp_pct=0.6, cohort_analysis=False, topk=1),
    "cohort": dict(tp_pct=0.6, cohort_analysis=True, topk=1),
    "cohort_top5": dict(tp_pct=0.6, cohort_analysis=True, topk=5),
    "static_only": dict(tp_pct=0.6, cohort_analysis=False, topk=1,
                        static_only=True),
    "oracle_top5": dict(tp_pct=0.6, cohort_analysis=False, topk=5,
                        association_oracle=True),
}


def golden_records(mod):
    z = np.load(os.path.join(FIX, "metrics_golden.npz"))
    preds = [mod.PredRecord(
        sample=str(z["pred_sample"][i]), centers=z["pred_centers"][i],
        size=z["pred_size"][i], yaw=float(z["pred_yaw"][i]),
        vel=z["pred_vel"][i], det_score=float(z["pred_det_score"][i]),
        forecast_score=float(z["pred_forecast_score"][i]),
        forecast_id=int(z["pred_forecast_id"][i]),
        classname=str(z["pred_classname"][i]), attr=str(z["pred_attr"][i]))
        for i in range(len(z["pred_sample"]))]
    gts = [mod.GTRecord(
        sample=str(z["gt_sample"][i]), centers=z["gt_centers"][i],
        size=z["gt_size"][i], yaw=float(z["gt_yaw"][i]), vel=z["gt_vel"][i],
        classname=str(z["gt_classname"][i]), cohort=str(z["gt_cohort"][i]),
        attr=str(z["gt_attr"][i]))
        for i in range(len(z["gt_sample"]))]
    return preds, gts


def assert_tree(got, want, atol, path=""):
    assert set(got) == set(want), f"{path}: keys {set(got) ^ set(want)}"
    for k in want:
        if isinstance(want[k], dict):
            assert_tree(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=f"{path}/{k}")


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_golden_fixture_holds_for_the_port(setting, use_native):
    with open(os.path.join(FIX, "metrics_golden.json")) as f:
        expected = json.load(f)[setting]
    preds, gts = golden_records(M)
    res = M.evaluate_forecasts(preds, gts, ["car", "pedestrian"],
                               horizon_seconds=3.0, native=use_native,
                               **SETTINGS[setting])
    assert_tree(res.summary(), expected, GOLDEN_ATOL, setting)


def random_world(mod, seed, n_samples=5, n_gt=10, n_pred=28, T=7):
    """Noisy copies of GT trajectories and false positives, multi-future
    groups, attributes, cohorts, two classes, some records out of range."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for s in range(n_samples):
        tok = f"s{s}"
        for _ in range(n_gt):
            cls = ("car", "pedestrian")[rng.integers(2)]
            start = rng.uniform(-55, 55, 2)
            vel = rng.uniform(-5, 5, 2)
            centers = start[None] + np.arange(T)[:, None] * 0.5 * vel[None]
            if rng.random() < 0.3:
                centers = centers + rng.normal(0, 2.0, (T, 2)).cumsum(0)
            gts.append(mod.GTRecord(
                tok, centers, rng.uniform(0.5, 3, 3), rng.uniform(-3, 3),
                vel, cls,
                cohort=("static", "linear", "nonlinear")[rng.integers(3)],
                attr=("", "vehicle.moving", "vehicle.parked")[
                    rng.integers(3)]))
        for _ in range(n_pred):
            if rng.random() < 0.7:
                g = gts[len(gts) - n_gt + int(rng.integers(n_gt))]
                centers = g.centers + rng.normal(0, 0.8, (T, 2))
                vel = g.vel + rng.normal(0, 0.5, 2)
                size = g.size * rng.uniform(0.8, 1.2, 3)
                yaw, cls = g.yaw + rng.normal(0, 0.3), g.classname
            else:
                start = rng.uniform(-55, 55, 2)
                vel = rng.uniform(-5, 5, 2)
                centers = (start[None]
                           + np.arange(T)[:, None] * 0.5 * vel[None]
                           + rng.normal(0, 0.7, (T, 2)))
                size = rng.uniform(0.5, 3, 3)
                yaw = rng.uniform(-3, 3)
                cls = ("car", "pedestrian")[rng.integers(2)]
            preds.append(mod.PredRecord(
                tok, centers, size, float(yaw), vel, float(rng.random()),
                float(rng.random()), int(rng.integers(-1, 6)), cls,
                attr=("vehicle.moving", "vehicle.parked")[rng.integers(2)]))
    return preds, gts


@pytest.mark.parametrize("seed,kw", [
    (0, dict(topk=1)),
    (1, dict(topk=3, cohort_analysis=True)),
    (2, dict(topk=2, association_oracle=True, tp_pct=0.8)),
    (3, dict(topk=1, static_only=True, horizon_seconds=2.5)),
])
def test_random_records_match_jax_on_numpy(monkeypatch, seed, kw):
    monkeypatch.setattr(JM, "_USE_NATIVE", False)
    want = JM.evaluate_forecasts(*random_world(JM, seed),
                                 ["car", "pedestrian"], **kw)
    got = M.evaluate_forecasts(*random_world(M, seed),
                               ["car", "pedestrian"], native=False, **kw)
    assert_tree(got.summary(), want.summary(), NUMPY_ATOL)
    # the records match: some AP above 0, some error off its 1.0 default
    assert max(want.mean_dist_aps.values()) > 0
    assert any(e["avg_disp_err"] != 1.0
               for e in want.label_tp_errors.values())


@pytest.mark.parametrize("seed,topk,oracle", [(0, 1, False), (1, 3, False),
                                              (2, 1, True)])
def test_native_matches_numpy(seed, topk, oracle):
    """As tests/test_native_metrics.py holds the JAX package's matcher."""
    preds, gts = random_world(M, seed)
    kw = dict(topk=topk, cohort_analysis=True, association_oracle=oracle)
    ref = M.evaluate_forecasts(preds, gts, ["car"], native=False, **kw)
    out = M.evaluate_forecasts(preds, gts, ["car"], native=True, **kw)
    for name in ("mean_dist_aps", "mean_dist_ars", "mean_dist_faps",
                 "mean_dist_fars", "mean_dist_aaps", "mean_dist_aars",
                 "mean_dist_faps_mr"):
        a, b = getattr(ref, name), getattr(out, name)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-5), (name, k)
    for cls in ref.label_tp_errors:
        for k, v in ref.label_tp_errors[cls].items():
            assert v == pytest.approx(out.label_tp_errors[cls][k],
                                      abs=1e-4), (cls, k)


def test_native_accumulate_direct():
    preds, gts = random_world(M, 7, n_samples=3, n_gt=8, n_pred=20)
    units, key = M._make_units(preds, True, 2)
    gt_index = M._gt_index(gts)
    nat = M._flatten_for_native(units, gts, gt_index)
    kw = dict(use_forecast_score=True, final_match_th=2.0, topk=2,
              units=units, key=key, gt_index=gt_index)
    a = M._accumulate(preds, gts, 2.0, native_data=nat, use_native=True,
                      **kw)
    b = M._accumulate(preds, gts, 2.0, use_native=False, **kw)
    np.testing.assert_array_equal(a["tp"], b["tp"])
    np.testing.assert_array_equal(a["fp"], b["fp"])
    np.testing.assert_allclose(a["conf"], b["conf"], atol=1e-7)
    assert a["tp"][-1] > 5
    for k in a["errs"]:
        np.testing.assert_allclose(a["errs"][k], b["errs"][k], atol=1e-4,
                                   err_msg=k)


def test_native_matches_the_jax_packages_matcher(monkeypatch):
    """The port's copy of fd_accumulate2 and the JAX package's library give
    the same bits on the same flattened inputs."""
    from futuredet_tpu.utils import native as jax_native
    if not jax_native.available():
        pytest.skip("the JAX package's host library did not build")
    preds, gts = random_world(M, 8)
    units, _ = M._make_units(preds, True, 3)
    nat = M._flatten_for_native(units, gts, M._gt_index(gts))
    for th, final, t, oracle in ((0.5, None, 0, False), (2.0, 2.0, 0, True),
                                 (4.0, None, 6, False)):
        kw = dict(dist_th=th, final_match_th=final, match_timestep=t,
                  association_oracle=oracle, mr_thresh=M.MR_THRESH)
        tp, errs = native.accumulate_native(*nat, **kw)
        jtp, jerrs = jax_native.accumulate_native(*nat, **kw)
        np.testing.assert_array_equal(tp, jtp)
        np.testing.assert_array_equal(errs, jerrs)


def test_a_failed_matcher_build_raises(monkeypatch, tmp_path):
    """No silent numpy fallback: without a compiler the native path
    raises, and only native=False runs numpy."""
    import shutil
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    preds, gts = random_world(M, 4, n_samples=2)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        M.evaluate_forecasts(preds, gts, ["car"])
    M.evaluate_forecasts(preds, gts, ["car"], native=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_trajectories_matches_jax(seed):
    rng = np.random.default_rng(seed)
    N, T = 200, 7
    start = rng.uniform(-30, 30, (N, 1, 2))
    vel = rng.uniform(-4, 4, (N, 2))
    steps = np.arange(T)[None, :, None] * 0.5 * vel[:, None]
    kind = rng.integers(3, size=N)
    centers = start + np.where(kind[:, None, None] == 0, 0.1 * steps, steps)
    centers[kind == 2] += rng.normal(0, 3, (int((kind == 2).sum()), T, 2))
    wl = rng.uniform(0.5, 5, (N, 2))
    times = np.full(T - 1, 0.5)
    got = trajectory.classify_trajectories(centers, vel, wl, times)
    want = jax_trajectory.classify_trajectories(centers, vel, wl, times)
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1, 2}
    assert trajectory.TRAJECTORY_NAMES == jax_trajectory.TRAJECTORY_NAMES
    # the metric engine's per-trajectory form of the same rule
    cohorts = [M.classify_cohort(c, v, s, float(times.sum()))
               for c, v, s in zip(centers, vel, wl)]
    assert cohorts == [JM.classify_cohort(c, v, s, float(times.sum()))
                       for c, v, s in zip(centers, vel, wl)]
    assert cohorts == [trajectory.TRAJECTORY_NAMES[k] for k in got]

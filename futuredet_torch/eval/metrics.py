"""Joint detection + forecasting evaluation metrics.

The port's copy of `futuredet_tpu/eval/metrics.py`: a re-implementation of
the external `nuscenes-forecast` devkit consumed by the reference
(`eval_main`, det3d/datasets/nuscenes/nusc_common.py:667-688; metric names
consumed at evaluate.py:22-54,184-201), reconstructed from the standard
nuScenes detection eval, the FutureDet paper's (arXiv:2203.16297) metric
definitions and the consumption sites:

  mean_dist_aps  (mAP)   — center-distance AP at {0.5,1,2,4} m, matched at
                           t=0
  mean_dist_ars  (mAR)   — max recall at each threshold, averaged
  mean_dist_faps (mFAP)  — forecasting AP: TP requires a match at t=0 AND at
                           the FINAL timestep; ranked by forecast_score; with
                           K>1, forecast_id groups are judged by their best
                           member (multi-future top-K)
  mean_dist_fars (mFAR)  — max recall of the FAP matching
  mean_dist_aaps (mAAP)  — average AP: AP requiring a match at timestep t,
                           averaged over all T timesteps
  mean_dist_faps_mr      — FAP where the final-timestep criterion is the
                           miss-rate threshold (2 m) instead of the sweep
                           threshold
  label_tp_errors        — ATE/ASE/AOE/AVE/AAE + ADE/FDE/MR computed over TPs
                           of the 2 m matching, averaged over the recall range
                           [10%, tp_pct]
  cohort_analysis        — classes become {static,linear,nonlinear}_{cls}
                           using GT trajectory labels (ref README.md:183)

All inputs are plain numpy; this runs on the host after decode and linking.
The greedy matching runs in the port's C++ matcher (`utils/native.py`,
fp32 distances) unless `native=False` asks for the numpy one (fp64); a
failed build of the matcher raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import native

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0
MR_THRESH = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_SAMPLES = 101
COHORTS = ("static", "linear", "nonlinear")

# Per-class eval range in meters from ego (the nuScenes detection eval's
# class_range, detection_cvpr_2019 — applied by the devkit's
# filter_eval_boxes to BOTH GT and predictions before accumulation; the
# reference consumes it implicitly through eval_main,
# reference det3d/datasets/nuscenes/nusc_common.py:667-688).
# Records are in the reference lidar frame, so ego distance = |center(t=0)|.
CLASS_RANGES = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}


@dataclass
class PredRecord:
    sample: str
    centers: np.ndarray        # (T, 2) trajectory centers
    size: np.ndarray           # (3,) w, l, h
    yaw: float
    vel: np.ndarray            # (2,)
    det_score: float
    forecast_score: float
    forecast_id: int
    classname: str
    attr: str = ""             # attribute name (speed heuristic, serialize)


@dataclass
class GTRecord:
    sample: str
    centers: np.ndarray        # (T, 2)
    size: np.ndarray
    yaw: float
    vel: np.ndarray
    classname: str
    cohort: str = "static"
    attr: str = ""             # annotation attribute ("" = none -> AAE skips)


def _yaw_diff(a, b):
    d = (a - b + np.pi) % (2 * np.pi) - np.pi
    return abs(d)


def _make_units(preds: List[PredRecord], use_forecast_score: bool, topk: int):
    """Score-sorted evaluation units. Predictions sharing
    (sample, forecast_id) are ONE multi-future group: grouping is
    unconditional (else the many-to-one tracker's extra trajectories at the
    same start box all count as FPs); topk controls how many members of a
    group may be tried against the GT."""
    key = lambda p: p.forecast_score if use_forecast_score else p.det_score
    groups: Dict[Tuple[str, int], List[PredRecord]] = {}
    singles: List[List[PredRecord]] = []
    for p in preds:
        if p.forecast_id >= 0:
            groups.setdefault((p.sample, p.forecast_id), []).append(p)
        else:
            singles.append([p])
    units = list(groups.values()) + singles
    units = [sorted(u, key=key, reverse=True)[:max(topk, 1)] for u in units]
    units.sort(key=lambda u: key(u[0]), reverse=True)
    return units, key


def _gt_index(gts: List[GTRecord]):
    gt_by_sample: Dict[str, List[int]] = {}
    for i, g in enumerate(gts):
        gt_by_sample.setdefault(g.sample, []).append(i)
    # per-sample (G, T, 2) center blocks for vectorized distances
    gt_centers = {s: np.stack([gts[i].centers for i in idx])
                  for s, idx in gt_by_sample.items()}
    return gt_by_sample, gt_centers


def _flatten_for_native(units, gts: List[GTRecord], gt_index):
    """Flat arrays for the C++ greedy matcher (csrc fd_accumulate).

    GTs are regrouped contiguously per sample; predictions carry the sample
    id (-1 when the sample has no GTs). Returns None when there is nothing
    to flatten."""
    gt_by_sample, _ = gt_index
    sample_to_id = {s: k for k, s in enumerate(gt_by_sample)}
    gt_rows = [i for idx in gt_by_sample.values() for i in idx]
    offs = np.zeros(len(gt_by_sample) + 1, np.int32)
    for k, idx in enumerate(gt_by_sample.values()):
        offs[k + 1] = offs[k] + len(idx)
    gt_centers = np.ascontiguousarray(
        np.stack([gts[i].centers for i in gt_rows]), np.float32)
    gt_size = np.ascontiguousarray(
        np.stack([gts[i].size for i in gt_rows]), np.float32)
    gt_yaw = np.ascontiguousarray(
        np.array([gts[i].yaw for i in gt_rows]), np.float32)
    gt_vel = np.ascontiguousarray(
        np.stack([gts[i].vel for i in gt_rows]), np.float32)
    # attribute vocabulary: ids shared between GT and members; -1 = no attr
    attr_vocab: Dict[str, int] = {}

    def attr_id(a: str) -> int:
        if not a:
            return -1
        if a not in attr_vocab:
            attr_vocab[a] = len(attr_vocab)
        return attr_vocab[a]

    gt_attr = np.ascontiguousarray(
        np.array([attr_id(gts[i].attr) for i in gt_rows], np.int32))

    members = [p for u in units for p in u]
    uoffs = np.zeros(len(units) + 1, np.int32)
    for k, u in enumerate(units):
        uoffs[k + 1] = uoffs[k] + len(u)
    if members:
        mem_sample = np.array([sample_to_id.get(p.sample, -1)
                               for p in members], np.int32)
        mem_centers = np.ascontiguousarray(
            np.stack([p.centers for p in members]), np.float32)
        mem_size = np.ascontiguousarray(
            np.stack([p.size for p in members]), np.float32)
        mem_yaw = np.ascontiguousarray(
            np.array([p.yaw for p in members]), np.float32)
        mem_vel = np.ascontiguousarray(
            np.stack([p.vel for p in members]), np.float32)
        mem_attr = np.ascontiguousarray(
            np.array([attr_id(p.attr) for p in members], np.int32))
    else:
        T = gt_centers.shape[1]
        mem_sample = np.zeros((0,), np.int32)
        mem_centers = np.zeros((0, T, 2), np.float32)
        mem_size = np.zeros((0, 3), np.float32)
        mem_yaw = np.zeros((0,), np.float32)
        mem_vel = np.zeros((0, 2), np.float32)
        mem_attr = np.zeros((0,), np.int32)
    return (uoffs, mem_sample, mem_centers, mem_size, mem_yaw, mem_vel,
            mem_attr, offs, gt_centers, gt_size, gt_yaw, gt_vel, gt_attr)


def _accumulate(preds: List[PredRecord], gts: List[GTRecord], dist_th: float,
                *, use_forecast_score: bool, final_match_th: Optional[float],
                match_timestep: int = 0, topk: int = 1,
                association_oracle: bool = False, units=None, key=None,
                gt_index=None, native_data=None, use_native: bool = True):
    """Greedy score-ordered matching (nuScenes accumulate()).

    final_match_th: if set, a TP additionally requires final-timestep center
    distance < final_match_th (forecasting AP).
    match_timestep: which timestep's centers must match dist_th (for AAP).
    units/key/gt_index: optional precomputed structures (shared across the
    ~40 threshold/timestep passes by evaluate_forecasts).
    use_native: match in the C++ matcher (`native_data`, flattened here when
    not given) rather than in numpy.

    Returns dict with tp/fp cumsums, per-TP errors, npos.
    """
    npos = len(gts)
    if npos == 0:
        return None

    if units is None or key is None:
        units, key = _make_units(preds, use_forecast_score, topk)
    if gt_index is None:
        gt_index = _gt_index(gts)

    # the greedy loop in C++ (csrc/host_accumulate.cpp)
    if use_native:
        if native_data is None:
            native_data = _flatten_for_native(units, gts, gt_index)
        tp_flags, errs8 = native.accumulate_native(
            *native_data, dist_th=dist_th, final_match_th=final_match_th,
            match_timestep=match_timestep,
            association_oracle=association_oracle, mr_thresh=MR_THRESH)
        tp_f = tp_flags.astype(np.float64)
        names = ("trans_err", "scale_err", "orient_err", "vel_err",
                 "attr_err", "avg_disp_err", "final_disp_err", "miss")
        sel = tp_flags.astype(bool)
        return {"tp": np.cumsum(tp_f), "fp": np.cumsum(1.0 - tp_f),
                "conf": np.array([key(u[0]) for u in units]),
                "errs": {n: errs8[sel, k].astype(np.float64)
                         for k, n in enumerate(names)},
                "npos": npos}

    gt_by_sample, gt_centers = gt_index
    gt_centers_t = {s: c[:, match_timestep] for s, c in gt_centers.items()}
    taken = np.zeros(npos, bool)

    tp, fp = [], []
    errs = {k: [] for k in ("trans_err", "scale_err", "orient_err", "vel_err",
                            "attr_err", "avg_disp_err", "final_disp_err",
                            "miss")}
    conf = []
    for unit in units:
        matched = False
        for p in unit:
            idx = gt_by_sample.get(p.sample)
            if idx is None:
                continue
            free = ~taken[idx]
            if not free.any():
                continue
            d_all = np.linalg.norm(
                gt_centers_t[p.sample] - p.centers[match_timestep], axis=1)
            d_all = np.where(free, d_all, np.inf)
            j = int(np.argmin(d_all))
            if d_all[j] >= dist_th:
                continue
            gi = idx[j]
            g = gts[gi]
            if association_oracle:
                # oracle association (ref --association_oracle,
                # tools/dist_test.py:93): the matched GT's future replaces the
                # predicted future, isolating detection quality
                p = PredRecord(p.sample, g.centers.copy(), p.size, p.yaw,
                               p.vel, p.det_score, p.forecast_score,
                               p.forecast_id, p.classname)
            if final_match_th is not None:
                dF = np.linalg.norm(p.centers[-1] - g.centers[-1])
                if dF >= final_match_th:
                    continue
            taken[gi] = True
            matched = True
            # TP errors (nuScenes definitions)
            disp = np.linalg.norm(p.centers - g.centers, axis=1)
            errs["trans_err"].append(float(disp[0]))
            inter = np.prod(np.minimum(p.size, g.size))
            union = np.prod(p.size) + np.prod(g.size) - inter
            errs["scale_err"].append(1.0 - inter / max(union, 1e-9))
            errs["orient_err"].append(_yaw_diff(p.yaw, g.yaw))
            errs["vel_err"].append(float(np.linalg.norm(p.vel - g.vel)))
            # nuScenes attr_acc: nan (excluded from the cummean) when the
            # GT carries no attribute, else exact-name mismatch
            errs["attr_err"].append(
                np.nan if not g.attr else float(p.attr != g.attr))
            errs["avg_disp_err"].append(float(np.mean(disp)))
            errs["final_disp_err"].append(float(disp[-1]))
            errs["miss"].append(float(disp[-1] > MR_THRESH))
            break
        tp.append(1.0 if matched else 0.0)
        fp.append(0.0 if matched else 1.0)
        conf.append(key(unit[0]))

    return {"tp": np.cumsum(tp), "fp": np.cumsum(fp), "conf": np.array(conf),
            "errs": {k: np.array(v) for k, v in errs.items()}, "npos": npos}


def _calc_ap(acc) -> Tuple[float, float]:
    """nuScenes calc_ap + max recall. Returns (ap, max_recall)."""
    if acc is None or len(acc["tp"]) == 0:
        return 0.0, 0.0
    rec = acc["tp"] / acc["npos"]
    prec = acc["tp"] / (acc["tp"] + acc["fp"])
    rec_interp = np.linspace(0, 1, N_RECALL_SAMPLES)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    start = round(100 * MIN_RECALL) + 1
    p = prec_i[start:] - MIN_PRECISION
    p[p < 0] = 0
    return float(np.mean(p) / (1 - MIN_PRECISION)), float(rec[-1])


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean that skips NaN entries (nuScenes utils.cummean):
    all-NaN input -> ones; prefixes before the first finite value -> 0."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals > 0)


def _calc_tp_errors(acc, tp_pct: float) -> Dict[str, float]:
    """Cumulative-mean TP errors averaged over recall in [10%, tp_pct]
    (nuScenes calc_tp with the fork's tp_pct recall cap)."""
    out = {}
    names = ["trans_err", "scale_err", "orient_err", "vel_err", "attr_err",
             "avg_disp_err", "final_disp_err"]
    if acc is None or len(acc["tp"]) == 0 or acc["tp"][-1] == 0:
        return {k: 1.0 for k in names} | {"miss_rate": 1.0}
    rec = acc["tp"] / acc["npos"]
    tp_mask = (np.diff(np.concatenate([[0.0], acc["tp"]])) > 0)
    rec_interp = np.linspace(0, 1, N_RECALL_SAMPLES)
    max_rec = min(rec[-1], tp_pct)
    last = int(round(100 * max_rec)) + 1
    first = round(100 * MIN_RECALL) + 1
    for name in names + ["miss"]:
        e = acc["errs"][name]
        if len(e) == 0 or np.all(np.isnan(e)):
            out[name if name != "miss" else "miss_rate"] = 1.0
            continue
        cum = _cummean(e)
        rec_tp = rec[tp_mask]
        ei = np.interp(rec_interp, rec_tp, cum, right=cum[-1])
        if last <= first:
            val = float(cum[-1])
        else:
            val = float(np.mean(ei[first:last]))
        out[name if name != "miss" else "miss_rate"] = val
    return out


@dataclass
class EvalResult:
    mean_dist_aps: Dict[str, float]
    mean_dist_ars: Dict[str, float]
    mean_dist_faps: Dict[str, float]
    mean_dist_fars: Dict[str, float]
    mean_dist_aaps: Dict[str, float]
    mean_dist_aars: Dict[str, float]
    mean_dist_faps_mr: Dict[str, float]
    label_tp_errors: Dict[str, Dict[str, float]]

    def summary(self) -> Dict:
        return {
            "mean_dist_aps": self.mean_dist_aps,
            "mean_dist_ars": self.mean_dist_ars,
            "mean_dist_faps": self.mean_dist_faps,
            "mean_dist_fars": self.mean_dist_fars,
            "mean_dist_aaps": self.mean_dist_aaps,
            "mean_dist_aars": self.mean_dist_aars,
            "mean_dist_faps_mr": self.mean_dist_faps_mr,
            "label_tp_errors": self.label_tp_errors,
        }


def classify_cohort(centers: np.ndarray, vel: np.ndarray, size: np.ndarray,
                    seconds: float) -> str:
    """static/linear/nonlinear by the reference trajectory() rule
    (nusc_common.py:311-333) applied to a trajectory's own motion."""
    target = centers[-1]
    thresh = max(size[0], size[1])
    if np.linalg.norm(target - centers[0]) < thresh:
        return "static"
    if np.linalg.norm(target - (centers[0] + vel * seconds)) < thresh:
        return "linear"
    return "nonlinear"


def evaluate_forecasts(preds: List[PredRecord], gts: List[GTRecord],
                       class_names: Sequence[str], *, tp_pct: float = 0.6,
                       cohort_analysis: bool = False, topk: int = 1,
                       static_only: bool = False,
                       association_oracle: bool = False,
                       horizon_seconds: float = 3.0,
                       class_ranges: Optional[Dict[str, float]] = None,
                       native: bool = True) -> EvalResult:
    """Full metric computation over all samples. native: greedy matching
    in the C++ matcher (fp32; its build raises on failure), else in numpy
    (fp64)."""
    # class-range filter (devkit filter_eval_boxes): drop preds AND GT whose
    # t=0 center lies beyond the per-class eval range from ego. Records are
    # in the reference lidar frame, so ego distance = |center(0)|. The
    # devkit's companion num_pts>0 GT filter is applied upstream at info
    # generation (filter_zero, data/infos.py).
    ranges = CLASS_RANGES if class_ranges is None else class_ranges
    if ranges:
        rng_of = lambda cls: ranges.get(cls, np.inf)
        preds = [p for p in preds
                 if np.linalg.norm(p.centers[0]) < rng_of(p.classname)]
        gts = [g for g in gts
               if np.linalg.norm(g.centers[0]) < rng_of(g.classname)]

    if cohort_analysis:
        eval_classes = [f"{c}_{cls}" for cls in class_names for c in COHORTS]

        def gt_class(g):
            return f"{g.cohort}_{g.classname}"

        # predictions self-classify by their own predicted motion, with the
        # same static/linear/nonlinear rule used for GT tracklets —
        # vectorized once over all predictions (it dominated eval time when
        # recomputed per cohort class)
        if preds:
            c0 = np.stack([p.centers[0] for p in preds])
            ct = np.stack([p.centers[-1] for p in preds])
            vel = np.stack([p.vel for p in preds])
            th = np.stack([max(p.size[0], p.size[1]) for p in preds])
            static = np.linalg.norm(ct - c0, axis=1) < th
            linear = np.linalg.norm(
                ct - (c0 + vel * horizon_seconds), axis=1) < th
            cohort_idx = np.where(static, 0, np.where(linear, 1, 2))
            pred_names = [f"{COHORTS[c]}_{p.classname}"
                          for p, c in zip(preds, cohort_idx)]
        else:
            pred_names = []
    else:
        eval_classes = list(class_names)

        def gt_class(g):
            return g.classname

        pred_names = [p.classname for p in preds]

    if static_only:
        gts = [g for g in gts if g.cohort == "static"]

    aps, ars, faps, fars, aaps, aars, faps_mr = ({} for _ in range(7))
    tp_errors = {}
    T = gts[0].centers.shape[0] if gts else 1

    for cls in eval_classes:
        cls_gts = [g for g in gts if gt_class(g) == cls]
        cls_preds = [p for p, n in zip(preds, pred_names) if n == cls]

        # precomputed structures shared across all ~40 passes of this class
        units_det, key_det = _make_units(cls_preds, False, topk)
        units_fc, key_fc = _make_units(cls_preds, True, topk)
        gt_index = _gt_index(cls_gts) if cls_gts else None
        use_nat = native and gt_index is not None
        nat_det = _flatten_for_native(units_det, cls_gts, gt_index) \
            if use_nat else None
        nat_fc = _flatten_for_native(units_fc, cls_gts, gt_index) \
            if use_nat else None

        ap_list, ar_list, fap_list, far_list = [], [], [], []
        aap_list, aar_list, fapmr_list = [], [], []
        for th in DIST_THRESHOLDS:
            acc = _accumulate(cls_preds, cls_gts, th, use_forecast_score=False,
                              final_match_th=None, units=units_det,
                              key=key_det, gt_index=gt_index,
                              native_data=nat_det, use_native=use_nat)
            ap, ar = _calc_ap(acc)
            ap_list.append(ap)
            ar_list.append(ar)

            facc = _accumulate(cls_preds, cls_gts, th, use_forecast_score=True,
                               final_match_th=th, topk=topk,
                               association_oracle=association_oracle,
                               units=units_fc, key=key_fc, gt_index=gt_index,
                               native_data=nat_fc, use_native=use_nat)
            fap, far = _calc_ap(facc)
            fap_list.append(fap)
            far_list.append(far)

            fmracc = _accumulate(cls_preds, cls_gts, th,
                                 use_forecast_score=True,
                                 final_match_th=MR_THRESH, topk=topk,
                                 association_oracle=association_oracle,
                                 units=units_fc, key=key_fc,
                                 gt_index=gt_index, native_data=nat_fc,
                                 use_native=use_nat)
            fapmr_list.append(_calc_ap(fmracc)[0])

            taps, tars = [], []
            for t in range(T):
                tacc = _accumulate(cls_preds, cls_gts, th,
                                   use_forecast_score=True,
                                   final_match_th=None, match_timestep=t,
                                   topk=topk, units=units_fc, key=key_fc,
                                   gt_index=gt_index, native_data=nat_fc,
                                   use_native=use_nat)
                a, r = _calc_ap(tacc)
                taps.append(a)
                tars.append(r)
            aap_list.append(float(np.mean(taps)))
            aar_list.append(float(np.mean(tars)))

        aps[cls] = float(np.mean(ap_list))
        ars[cls] = float(np.mean(ar_list))
        faps[cls] = float(np.mean(fap_list))
        fars[cls] = float(np.mean(far_list))
        aaps[cls] = float(np.mean(aap_list))
        aars[cls] = float(np.mean(aar_list))
        faps_mr[cls] = float(np.mean(fapmr_list))

        acc_tp = _accumulate(cls_preds, cls_gts, TP_DIST,
                             use_forecast_score=True, final_match_th=None,
                             topk=topk, units=units_fc, key=key_fc,
                             gt_index=gt_index, native_data=nat_fc,
                             use_native=use_nat)
        tp_errors[cls] = _calc_tp_errors(acc_tp, tp_pct)

    return EvalResult(aps, ars, faps, fars, aaps, aars, faps_mr, tp_errors)

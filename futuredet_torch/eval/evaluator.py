"""End-to-end evaluation: detections -> linked trajectories -> joint
detection + forecasting metrics.

The port's copy of `futuredet_tpu/eval/evaluator.py`. Forward, decode and
NMS run on the device (`eval/decode.py`); this module is the host-side
aggregation that replaces the reference's `NuScenesDataset.evaluation`
(ref nuscenes.py:681-875): per sample it links per-timestep future
detections into trajectories (eval.linking), groups multi-futures,
re-ranks, and feeds the metric engine (eval.metrics). A `Detections` of
tensors is copied to the host once per batch (`host_detections`).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..config import ExperimentConfig
from ..core.trajectory import TRAJECTORY_NAMES
from .decode import Detections
from .linking import (jitter_trajectories, link_sample, multi_future,
                      snap_to_prototypes, split_by_timestep, trajectory_score)
from .metrics import EvalResult, GTRecord, PredRecord, evaluate_forecasts

DT = 0.5

# Most-common training-set attribute per class (ref cls_attr_dist,
# nusc_common.py:54-150 — only car/pedestrian are active in the fork; the
# serialization falls back to this when the speed heuristic abstains).
MOST_COMMON_ATTR = {"car": "vehicle.parked", "pedestrian": "pedestrian.moving"}


def host_detections(det: Detections) -> Detections:
    """The same Detections as host numpy arrays: one device-to-host copy of
    each field (a no-op for arrays already on the host)."""
    return Detections(*(x.detach().cpu().numpy() if hasattr(x, "detach")
                        else np.asarray(x) for x in det))


def pred_attribute(classname: str, speed: float) -> str:
    """Speed-heuristic attribute for a serialized detection
    (ref nuscenes.py:760-784): moving vehicles -> vehicle.moving, slow
    pedestrians -> pedestrian.standing, else the class's most common
    training-set attribute."""
    attr = None
    if speed > 0.2:
        if classname in ("car", "construction_vehicle", "bus", "truck",
                         "trailer"):
            attr = "vehicle.moving"
        elif classname in ("bicycle", "motorcycle"):
            attr = "cycle.with_rider"
    else:
        if classname == "pedestrian":
            attr = "pedestrian.standing"
        elif classname == "bus":
            attr = "vehicle.stopped"
    return attr if attr is not None else MOST_COMMON_ATTR.get(classname, "")


def detections_to_predictions(cfg: ExperimentConfig, det: Detections,
                              sample_tokens: Sequence[str], *,
                              forecast_mode: str = "velocity_dense",
                              classname: str = "car", rerank: str = "last",
                              nogroup: bool = False, jitter: bool = False,
                              jitter_K: int = 1, jitter_C: float = 1.0,
                              prototypes=None,
                              sample_times=None) -> List[PredRecord]:
    """Link each sample's Detections and serialize PredRecords
    (ref evaluation loop nuscenes.py:752-807).

    sample_times: optional per-sample list of (T-1) keyframe gaps in seconds
    (the reference computes them from sample timestamps, get_time
    nuscenes.py:57-62); defaults to the nominal 2 Hz spacing."""
    h = cfg.model.head
    if h.standard and len(h.tasks) > 1:
        raise NotImplementedError(
            "multi-task (class-group) configs emit GLOBAL CLASS ids as "
            "labels (decode.py), not pseudo-timestep indices — forecast "
            "linking/eval does not apply to them; use "
            "eval.evaluator.evaluate_detections_multitask "
            "(class-labeled records, per-class detection metrics) instead")
    T = cfg.model.head.target_timesteps
    default_times = [DT] * (T - 1)
    boxes, scores, labels, valid = host_detections(det)

    out: List[PredRecord] = []
    for b, tok in enumerate(sample_tokens):
        times = default_times
        if sample_times is not None and len(sample_times[b]) == T - 1:
            times = [float(t) for t in sample_times[b]]
        per_t = split_by_timestep(boxes[b], scores[b], labels[b], valid[b], T)
        trajs = link_sample(classname, forecast_mode, times, per_t)
        if prototypes is not None:
            trajs = snap_to_prototypes(trajs, prototypes)
        if jitter and jitter_K > 1:
            trajs = jitter_trajectories(trajs, times, jitter_K, jitter_C)
        if not nogroup:
            trajs = multi_future(trajs)
        for i, tr in enumerate(trajs):
            fs = trajectory_score(tr, rerank, T)
            vel = tr.boxes[0][6:8].copy()
            out.append(PredRecord(
                sample=tok, centers=tr.boxes[:, :2].copy(),
                size=tr.boxes[0][3:6].copy(), yaw=float(tr.boxes[0][8]),
                vel=vel, det_score=tr.det_score,
                forecast_score=fs,
                forecast_id=tr.forecast_id if not nogroup else -1,
                classname=classname,
                attr=pred_attribute(classname,
                                    float(np.linalg.norm(vel)))))
    return out


def multitask_detection_records(cfg: ExperimentConfig, det: Detections,
                                sample_tokens: Sequence[str]
                                ) -> List[PredRecord]:
    """Detection-only records for multi-task class-group configs: labels are
    GLOBAL CLASS ids (decode.py multi-task branch), trajectories are the
    single current timestep (classic CenterPoint evaluation regime)."""
    names = list(cfg.data.class_names)
    boxes, scores, labels, valid = host_detections(det)
    out: List[PredRecord] = []
    for b, tok in enumerate(sample_tokens):
        for i in np.nonzero(valid[b])[0]:
            box = boxes[b, i]
            s = float(scores[b, i])
            cls = names[int(labels[b, i])]
            out.append(PredRecord(
                sample=tok, centers=box[None, :2].copy(),
                size=box[3:6].copy(), yaw=float(box[8]),
                vel=box[6:8].copy(), det_score=s, forecast_score=s,
                forecast_id=-1, classname=cls,
                attr=pred_attribute(
                    cls, float(np.linalg.norm(box[6:8])))))
    return out


def gt_records_multiclass(gt_boxes, gt_valid, gt_classes,
                          sample_tokens: Sequence[str],
                          class_names: Sequence[str]) -> List[GTRecord]:
    """Per-class GTRecords at the current timestep (multi-task detection
    eval). gt_classes (B, T, M) 1-based global class ids."""
    out: List[GTRecord] = []
    B, T, M, _ = gt_boxes.shape
    for b in range(B):
        for k in range(M):
            if not gt_valid[b, 0, k]:
                continue
            cls = int(gt_classes[b, 0, k])
            if not (1 <= cls <= len(class_names)):
                continue
            box = gt_boxes[b, 0, k]
            out.append(GTRecord(
                sample=sample_tokens[b], centers=box[None, :2].copy(),
                size=box[3:6].copy(), yaw=float(-box[10] - np.pi / 2),
                vel=box[6:8].copy(), classname=class_names[cls - 1]))
    return out


def evaluate_detections_multitask(cfg: ExperimentConfig, det: Detections,
                                  gt, sample_tokens: Sequence[str], *,
                                  tp_pct: float = 0.6, topk: int = 1,
                                  cohort_analysis: bool = False,
                                  static_only: bool = False,
                                  association_oracle: bool = False
                                  ) -> EvalResult:
    """One-call detection evaluation for multi-task class-group configs:
    class-labeled records, stored-yaw conversion, per-class metrics. `gt` =
    dict with boxes (B,T,M,12), valid (B,T,M), classes (B,T,M)."""
    preds = multitask_detection_records(cfg, det, sample_tokens)
    for p in preds:
        p.yaw = float(-p.yaw - np.pi / 2)
    gts = gt_records_multiclass(np.asarray(gt["boxes"]),
                                np.asarray(gt["valid"]),
                                np.asarray(gt["classes"]), sample_tokens,
                                cfg.data.class_names)
    return evaluate_forecasts(
        preds, gts, list(cfg.data.class_names), tp_pct=tp_pct,
        cohort_analysis=cohort_analysis, topk=topk, static_only=static_only,
        association_oracle=association_oracle)


def gt_records_from_arrays(gt_boxes, gt_valid, traj_classes,
                           sample_tokens: Sequence[str],
                           classname: str = "car",
                           attrs=None) -> List[GTRecord]:
    """gt_boxes (B, T, M, 12) in the info layout -> GTRecords.

    attrs: optional (B, M) array of annotation attribute names ("" = none),
    plumbed from info["gt_attributes"] for the AAE metric."""
    out: List[GTRecord] = []
    B, T, M, _ = gt_boxes.shape
    for b in range(B):
        for k in range(M):
            if not gt_valid[b, 0, k]:
                continue
            boxes = gt_boxes[b, :, k]
            cohort = TRAJECTORY_NAMES[int(traj_classes[b, k]) - 1] \
                if traj_classes is not None else "static"
            out.append(GTRecord(
                sample=sample_tokens[b], centers=boxes[:, :2].copy(),
                size=boxes[0, 3:6].copy(),
                yaw=float(-boxes[0, 10] - np.pi / 2),
                vel=boxes[0, 6:8].copy(), classname=classname, cohort=cohort,
                attr=str(attrs[b][k]) if attrs is not None else ""))
    return out


def evaluate_detections(cfg: ExperimentConfig, det: Detections, gt,
                        sample_tokens: Sequence[str], *,
                        forecast_mode: str = "velocity_dense",
                        classname: str = "car", rerank: str = "last",
                        tp_pct: float = 0.6, cohort_analysis: bool = False,
                        topk: int = 1, static_only: bool = False,
                        nogroup: bool = False, association_oracle: bool = False,
                        jitter: bool = False, jitter_C: float = 1.0
                        ) -> EvalResult:
    """One-call evaluation used by tests and the trainer's validation. `gt`
    = dict with boxes (B,T,M,12), valid (B,T,M), traj (B,M)."""
    preds = detections_to_predictions(
        cfg, det, sample_tokens, forecast_mode=forecast_mode,
        classname=classname, rerank=rerank, nogroup=nogroup,
        jitter=jitter, jitter_K=topk, jitter_C=jitter_C)
    gts = gt_records_from_arrays(gt["boxes"], gt["valid"], gt.get("traj"),
                                 sample_tokens, classname)
    # yaw convention: GTRecord yaw converted from stored (-yaw-pi/2); decoded
    # boxes carry the stored convention too — convert pred yaw to match
    for p in preds:
        p.yaw = float(-p.yaw - np.pi / 2)
    return evaluate_forecasts(
        preds, gts, [classname], tp_pct=tp_pct,
        cohort_analysis=cohort_analysis, topk=topk, static_only=static_only,
        association_oracle=association_oracle)

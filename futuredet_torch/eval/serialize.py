"""nuScenes submission-format serialization.

The port's copy of `futuredet_tpu/eval/serialize.py`: the JSON schema the
reference writes (det3d/datasets/nuscenes/nuscenes.py:756-821 and
`box_serialize` :259-276): per-sample lists of annotations with
`forecast_boxes`, `forecast_score`, `forecast_id`, and the speed-based
attribute heuristics (:761-780).
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from .linking import Trajectory

# ref nusc_common.py cls_attr_dist most-frequent attributes
DEFAULT_ATTR = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "bicycle": "cycle.without_rider",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "trailer": "vehicle.parked",
}


def _attr_for(name: str, speed: float) -> str:
    """ref nuscenes.py:761-780."""
    if speed > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    else:
        if name == "pedestrian":
            return "pedestrian.standing"
        if name == "bus":
            return "vehicle.stopped"
    return DEFAULT_ATTR.get(name, "")


def _yaw_to_quat(yaw: float):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def serialize_trajectory(tr: Trajectory, sample_tokens: Sequence[str],
                         classname: str, forecast_score: float) -> dict:
    boxes = tr.boxes
    speed = float(np.linalg.norm(boxes[0][6:8]))
    attr = _attr_for(classname, speed)
    fboxes = []
    for t in range(boxes.shape[0]):
        b = boxes[t]
        tok = sample_tokens[min(t, len(sample_tokens) - 1)]
        fboxes.append({
            "sample_token": tok,
            "translation": [float(x) for x in b[:3]],
            "size": [float(x) for x in b[3:6]],
            "rotation": _yaw_to_quat(float(-b[8] - np.pi / 2)),
            "velocity": [float(x) for x in b[6:8]],
            "detection_name": classname,
            "detection_score": float(tr.scores[min(t, len(tr.scores) - 1)]),
            "forecast_score": forecast_score,
            "forecast_id": int(tr.forecast_id),
            "attribute_name": attr,
        })
    first = fboxes[0]
    return {
        "sample_token": first["sample_token"],
        "translation": first["translation"],
        "size": first["size"],
        "rotation": first["rotation"],
        "velocity": first["velocity"],
        "forecast_boxes": fboxes,
        "detection_name": classname,
        "detection_score": first["detection_score"],
        "forecast_score": forecast_score,
        "forecast_id": int(tr.forecast_id),
        "attribute_name": attr,
    }


def write_submission(path: str,
                     per_sample: Dict[str, List[dict]]) -> None:
    """per_sample: token -> list of serialized annotations."""
    doc = {
        "results": per_sample,
        "meta": {"use_camera": False, "use_lidar": True, "use_radar": False,
                 "use_map": False, "use_external": False},
    }
    with open(path, "w") as f:
        json.dump(doc, f)

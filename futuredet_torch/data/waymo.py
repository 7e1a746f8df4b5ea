"""Waymo dataset support (secondary, mirroring the reference's partial
support — `det3d/datasets/waymo/`, its README.md:190 marks Waymo as
unsupported/TODO; forecasting annotations are nuScenes-only there too).

The port's copy of `futuredet_tpu/data/waymo.py`. Scope = everything
reachable in the reference on top of DECODED frames:

- `create_waymo_infos` — behavioral port of
  `det3d/datasets/waymo/waymo_common.py:191-320`
  (`_fill_infos`/`sort_frame`/`get_available_frames`/`create_waymo_infos`):
  sweep chains with pose-composed transforms, Waymo→KITTI box conversion,
  zero-point GT filtering.
- `WaymoDataset` — decoded-frame dataset with multi-sweep aggregation
  (ref `pipelines/loading.py:62-98,142-170`) and `load_interval`
  (ref `waymo.py:35,55`).
- `create_pd_detection` — prediction dump for the Waymo devkit metric tool
  (ref `waymo_common.py:52-115`); writes the official `metrics_pb2`
  `detection_pred.bin` when `waymo_open_dataset` is importable, else a
  pickle with the identical record fields (the devkit is not a dependency
  of this repo, matching the reference which defers evaluation to the
  external tool — ref `waymo.py:94-104`).

The TFRecord→pkl decoder itself (ref `waymo_decoder.py`) requires
`tensorflow` + the `waymo_open_dataset` protos and is NOT reimplemented;
`decode_tfrecords` raises with a pointer when those are absent.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ExperimentConfig
from .pipeline import pack_gt, pack_points

# ref waymo_common.py:25-39
TYPE_LIST = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
CAT_NAME_TO_ID = {"VEHICLE": 1, "PEDESTRIAN": 2, "SIGN": 3, "CYCLIST": 4}
LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}  # model label -> waymo type (skips SIGN)


def get_obj(path: str):
    """ref waymo_common.py:33-36."""
    with open(path, "rb") as f:
        return pickle.load(f)


def read_waymo_frame(path: str) -> np.ndarray:
    """ref loading.py:62-71 `read_single_waymo`: tanh-normalized intensity,
    xyz + (intensity, elongation) concat -> (N, 5)."""
    obj = get_obj(path)
    xyz = np.asarray(obj["lidars"]["points_xyz"], np.float32)
    feat = np.asarray(obj["lidars"]["points_feature"], np.float32).copy()
    feat[:, 0] = np.tanh(feat[:, 0])
    return np.concatenate([xyz, feat], axis=-1).astype(np.float32)


def read_waymo_sweep(sweep: Dict) -> np.ndarray:
    """ref loading.py:73-92 `read_single_waymo_sweep`: transform the sweep
    into the reference frame, append the time-lag column -> (N, 6)."""
    pts = read_waymo_frame(sweep["path"])
    tm = sweep.get("transform_matrix")
    if tm is not None:
        tm = np.asarray(tm, np.float64)
        pts[:, :3] = (pts[:, :3] @ tm[:3, :3].T + tm[:3, 3]).astype(np.float32)
    lag = np.full((len(pts), 1), float(sweep["time_lag"]), np.float32)
    return np.hstack([pts, lag])


def _pose_transforms(veh_to_global: np.ndarray):
    """ref waymo_common.py:176-189 `veh_pos_to_transform`: a 4x4 vehicle
    pose -> (global_from_car, car_from_global). The reference round-trips
    through a quaternion; for an orthonormal rotation block that is the
    identity map, so we invert directly."""
    pose = np.reshape(np.asarray(veh_to_global, np.float64), (4, 4))
    global_from_car = pose.copy()
    car_from_global = np.eye(4)
    r, t = pose[:3, :3], pose[:3, 3]
    car_from_global[:3, :3] = r.T
    car_from_global[:3, 3] = -r.T @ t
    return global_from_car, car_from_global


def _frame_ids(frame_name: str):
    """seq/frame ids from 'seq_{s}_frame_{f}.pkl' (ref :212-213)."""
    parts = frame_name.split("_")
    return int(parts[1]), int(parts[3].split(".")[0])


def sort_frame(frames: Sequence[str]) -> List[str]:
    """ref waymo_common.py:282-295: argsort by seq_id*1000 + frame_id."""
    indices = [s * 1000 + f for s, f in map(_frame_ids, frames)]
    return [frames[r] for r in np.argsort(np.array(indices))]


def get_available_frames(root: str, split: str) -> List[str]:
    """ref waymo_common.py:297-304."""
    return sort_frame(list(os.listdir(os.path.join(root, split, "lidar"))))


def convert_box_to_kitti(gt_boxes: np.ndarray) -> np.ndarray:
    """ref waymo_common.py:265-270: Waymo [x,y,z,l,w,h,vx,vy,heading]
    (rotation from +x, clockwise) -> KITTI-convention
    [x,y,z,w,l,h,vx,vy,rot] with rot = -pi/2 - heading."""
    out = np.array(gt_boxes, np.float32).reshape(-1, 9)
    if len(out):
        out[:, -1] = -np.pi / 2 - out[:, -1]
        out[:, [3, 4]] = out[:, [4, 3]]
    return out


def _fill_infos(root_path: str, frames: Sequence[str], split: str = "train",
                nsweeps: int = 1) -> List[Dict]:
    """ref waymo_common.py:191-280."""
    infos = []
    anno_cache: Dict[str, Dict] = {}

    def cached_obj(path):
        if path not in anno_cache:
            anno_cache[path] = get_obj(path)
        return anno_cache[path]

    for frame_name in frames:
        lidar_path = os.path.join(root_path, split, "lidar", frame_name)
        ref_path = os.path.join(root_path, split, "annos", frame_name)
        ref_obj = cached_obj(ref_path)
        ref_time = 1e-6 * int(ref_obj["frame_name"].split("_")[-1])
        _, ref_from_global = _pose_transforms(ref_obj["veh_to_global"])

        info = {"path": lidar_path, "anno_path": ref_path,
                "token": frame_name, "timestamp": ref_time, "sweeps": []}

        sequence_id, frame_id = _frame_ids(frame_name)
        prev_id = frame_id
        sweeps: List[Dict] = []
        while len(sweeps) < nsweeps - 1:
            if prev_id <= 0:
                # ref :218-228: pad with the ref frame itself, then repeat
                # the last sweep
                if not sweeps:
                    sweeps.append({"path": lidar_path, "token": frame_name,
                                   "transform_matrix": None, "time_lag": 0})
                else:
                    sweeps.append(sweeps[-1])
            else:
                prev_id -= 1
                curr_name = f"seq_{sequence_id}_frame_{prev_id}.pkl"
                curr_obj = cached_obj(
                    os.path.join(root_path, split, "annos", curr_name))
                global_from_car, _ = _pose_transforms(
                    curr_obj["veh_to_global"])
                tm = ref_from_global @ global_from_car
                time_lag = ref_time - 1e-6 * int(
                    curr_obj["frame_name"].split("_")[-1])
                sweeps.append({
                    "path": os.path.join(root_path, split, "lidar",
                                         curr_name),
                    "transform_matrix": tm, "time_lag": time_lag})
        info["sweeps"] = sweeps

        if split != "test":
            annos = ref_obj["objects"]
            num_points = np.array([a["num_points"] for a in annos])
            gt_boxes = convert_box_to_kitti(
                np.array([a["box"] for a in annos]).reshape(-1, 9))
            gt_names = np.array([TYPE_LIST[a["label"]] for a in annos])
            mask = (num_points > 0).reshape(-1)  # ref :273-277
            info["gt_boxes"] = gt_boxes[mask].astype(np.float32)
            info["gt_names"] = gt_names[mask].astype(str)
        infos.append(info)
    return infos


def create_waymo_infos(root_path: str, split: str = "train",
                       nsweeps: int = 1) -> str:
    """ref waymo_common.py:307-320; returns the written info path."""
    frames = get_available_frames(root_path, split)
    infos = _fill_infos(root_path, frames, split, nsweeps)
    out = os.path.join(
        root_path, f"infos_{split}_{nsweeps:02d}sweeps_filter_zero_gt.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    return out


def decode_tfrecords(*_a, **_k):
    """ref waymo_decoder.py — requires tensorflow + waymo_open_dataset."""
    raise ImportError(
        "TFRecord decoding needs `tensorflow` and `waymo_open_dataset` "
        "(not dependencies of futuredet_torch). Decode segments with the "
        "upstream decoder, then point create_waymo_infos at the "
        "{split}/{lidar,annos}/seq_*_frame_*.pkl layout.")


class WaymoDataset:
    """Decoded-frame Waymo dataset (ref waymo.py:19-104). Detection-only:
    Waymo infos carry no forecast tracklets in the reference either, so
    timesteps broadcast from t=0 via pack_gt."""

    def __init__(self, cfg: ExperimentConfig, info_path: str,
                 train: bool = True, seed: int = 0, load_interval: int = 1):
        self.cfg = cfg
        self.train = train
        self.rng = np.random.default_rng(seed)
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        # ref waymo.py:55
        self.infos = infos[::load_interval]

    def __len__(self):
        return len(self.infos)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        info = self.infos[idx]
        pts = read_waymo_frame(info["path"])
        chunks = [np.hstack([pts, np.zeros((len(pts), 1), np.float32)])]
        # ref loading.py:149-170: exactly nsweeps-1 stored sweeps
        for sweep in info.get("sweeps", [])[:max(0, cfg.data.nsweeps - 1)]:
            chunks.append(read_waymo_sweep(sweep))
        pts = np.concatenate(chunks, axis=0)

        raw = np.asarray(info.get("gt_boxes",
                                  np.zeros((0, 9), np.float32)), np.float32)
        if raw.ndim == 2 and raw.shape[-1] == 9:
            # [x,y,z,w,l,h,vx,vy,rot] -> stored 12-col layout
            # [x,y,z,w,l,h,vx,vy,rvx,rvy,rot,rrot]; single-frame GT, so
            # reverse velocity/rotation mirror the forward ones
            boxes = np.concatenate(
                [raw[:, :8], raw[:, 6:8], raw[:, 8:9], raw[:, 8:9]], -1)
        else:
            boxes = raw.reshape(len(raw), -1)
        gt_boxes, gt_cls, gt_valid, gt_traj, _ = pack_gt(
            cfg, boxes, np.asarray(info.get("gt_names", []), str),
            np.full((len(boxes), 1), "static"), cfg.data.class_names)
        points, pvalid = pack_points(pts, cfg.voxel.max_points, self.rng)
        return {"points": points, "points_valid": pvalid,
                "gt_boxes": gt_boxes, "gt_classes": gt_cls,
                "gt_valid": gt_valid, "traj_classes": gt_traj,
                "token": info.get("token", str(idx))}


def convert_detection_to_waymo(boxes: np.ndarray) -> np.ndarray:
    """ref waymo_common.py:67-72: decoded [x,y,z,w,l,h,...,rot] (rot last)
    -> Waymo [x,y,z,l,w,h,heading] with heading = -rot - pi/2."""
    out = np.asarray(boxes, np.float64)
    out = np.concatenate([out[:, :6], out[:, -1:]], -1).copy()
    out[:, -1] = -out[:, -1] - np.pi / 2
    out[:, [3, 4]] = out[:, [4, 3]]
    return out


def create_pd_detection(detections: Dict[str, Dict], infos: Sequence[Dict],
                        result_path: str,
                        class_names: Optional[Sequence[str]] = None) -> str:
    """Prediction dump for the Waymo devkit (ref waymo_common.py:52-115).

    detections: {token: {"box3d_lidar": (N, >=7) decoded boxes (rot last),
                 "scores": (N,), "label_preds": (N,) 0-based class ids}}.
    class_names orders label_preds -> TYPE ids via LABEL_TO_TYPE when the
    model's classes are (car, pedestrian, cyclist)-style; defaults to the
    reference's 0->VEHICLE, 1->PEDESTRIAN, 2->CYCLIST mapping.
    Writes `detection_pred.bin` (metrics_pb2) when waymo_open_dataset is
    available, else `detection_pred.pkl` with identical fields.
    """
    del class_names  # mapping fixed by LABEL_TO_TYPE, kept for API parity
    by_token = {i["token"]: i for i in infos}
    records = []
    for token, det in detections.items():
        info = by_token[token]
        obj = get_obj(info["anno_path"])
        box3d = convert_detection_to_waymo(np.asarray(det["box3d_lidar"]))
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["label_preds"])
        for i in range(len(box3d)):
            records.append({
                "context_name": obj["scene_name"],
                "frame_timestamp_micros":
                    int(obj["frame_name"].split("_")[-1]),
                "box": box3d[i].tolist(),  # x y z l w h heading
                "score": float(scores[i]),
                "type": LABEL_TO_TYPE[int(labels[i])],
            })
    try:
        from waymo_open_dataset import label_pb2
        from waymo_open_dataset.protos import metrics_pb2
    except ImportError:
        path = os.path.join(result_path, "detection_pred.pkl")
        with open(path, "wb") as f:
            pickle.dump(records, f)
        return path
    objects = metrics_pb2.Objects()
    for r in records:
        o = metrics_pb2.Object()
        o.context_name = r["context_name"]
        o.frame_timestamp_micros = r["frame_timestamp_micros"]
        box = label_pb2.Label.Box()
        (box.center_x, box.center_y, box.center_z, box.length, box.width,
         box.height, box.heading) = r["box"]
        o.object.box.CopyFrom(box)
        o.score = r["score"]
        o.object.type = r["type"]
        objects.objects.append(o)
    path = os.path.join(result_path, "detection_pred.bin")
    with open(path, "wb") as f:
        f.write(objects.SerializeToString())
    return path

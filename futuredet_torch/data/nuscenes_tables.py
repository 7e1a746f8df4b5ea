"""Minimal devkit-free nuScenes table access.

The port's copy of `futuredet_tpu/data/nuscenes_tables.py`. The reference
depends on the external nuScenes devkit (and the nuscenes-forecast fork);
neither is needed here: the raw dataset JSON tables (`{version}/
sample.json`, `sample_data.json`, `sample_annotation.json`,
`calibrated_sensor.json`, `ego_pose.json`, `scene.json`, ...) are read
directly, with the few geometric helpers the pipeline needs (quaternion
rotation, transform matrices, the devkit's finite-difference
`NuScenes.box_velocity`, the ego-centric map crop).

PIL is imported only where a map raster is read and rotated; a dataset
without a map raster never needs it.
"""
from __future__ import annotations

import json
import os
from functools import cached_property
from typing import Dict, List

import numpy as np

TABLES = ("scene", "sample", "sample_data", "sample_annotation",
          "calibrated_sensor", "ego_pose", "category", "instance",
          "log", "map", "attribute")


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_yaw(q) -> float:
    """Heading of the box x-axis projected to the ground plane (devkit
    `quaternion_yaw`, ref nusc_common.py:587+)."""
    rot = quat_to_rot(q)
    v = rot @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _pil_image():
    """PIL.Image, which only the map raster path needs."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading the nuScenes map raster needs PIL (Pillow), which is "
            "not installed; a dataset whose map table names no raster "
            "file needs no PIL") from e
    return Image


def quat_inverse(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def transform_matrix(translation, rotation_q, inverse=False) -> np.ndarray:
    """4x4 homogeneous transform (devkit geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    rot = quat_to_rot(rotation_q)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -(rot.T @ np.asarray(translation))
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = translation
    return tm


class NuScenesTables:
    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        self._t: Dict[str, list] = {}
        self._idx: Dict[str, dict] = {}
        for name in TABLES:
            path = os.path.join(dataroot, version, f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    self._t[name] = json.load(f)
            else:
                self._t[name] = []
            self._idx[name] = {r["token"]: r for r in self._t[name]}

    def table(self, name: str) -> list:
        return self._t[name]

    def get(self, name: str, token: str) -> dict:
        return self._idx[name][token]

    @cached_property
    def sample_tokens_by_scene(self) -> Dict[str, List[str]]:
        """Ordered sample tokens per scene (walking the `next` chain)."""
        out = {}
        for scene in self._t["scene"]:
            toks = []
            tok = scene["first_sample_token"]
            while tok:
                toks.append(tok)
                tok = self.get("sample", tok)["next"]
            out[scene["token"]] = toks
        return out

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5
                     ) -> np.ndarray:
        """Finite-difference global-frame velocity (devkit semantics: central
        difference over prev/next annotations; nan if unavailable)."""
        ann = self.get("sample_annotation", ann_token)
        has_prev = ann["prev"] != ""
        has_next = ann["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation", ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation", ann["next"]) if has_next else ann
        pos_first = np.asarray(first["translation"])
        pos_last = np.asarray(last["translation"])
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt

    @cached_property
    def _map_by_log(self) -> Dict[str, dict]:
        """log token -> map record (the devkit builds log['map_token'] by
        reverse-indexing map.log_tokens at load time)."""
        out = {}
        for m in self._t["map"]:
            for lt in m.get("log_tokens", []):
                out[lt] = m
        return out

    def _map_mask(self, filename: str):
        """Binarized uint8 {0,255} semantic map raster (devkit MapMask.mask;
        v1.0 map PNGs are binary drivable-area masks at 0.1 m/px)."""
        if not hasattr(self, "_mask_cache"):
            self._mask_cache = {}
        if filename not in self._mask_cache:
            Image = _pil_image()
            path = os.path.join(self.dataroot, filename)
            img = np.asarray(Image.open(path).convert("L"))
            self._mask_cache[filename] = \
                np.where(img > 0, 255, 0).astype(np.uint8)
        return self._mask_cache[filename]

    def get_ego_centric_map(self, sample_data_token: str,
                            axes_limit: float = 40.0) -> np.ndarray:
        """Ego-centred, ego-yaw-aligned crop of the map mask (devkit
        `NuScenes.get_ego_centric_map`; consumed at ref
        `nusc_common.py:508-509`). Returns (2L, 2L) uint8 with
        L = axes_limit / 0.1 px; zeros when the dataset ships no map.

        Pixel mapping follows devkit MapMask.transform_matrix:
        px = x / res, py = H - y / res (map image rows run top-down).
        Out-of-raster regions are zero-padded (the devkit would crop short;
        real nuScenes maps are large enough that ego never reaches the edge).
        """
        import math

        res = 0.1
        limit_px = int(axes_limit / res)
        sd = self.get("sample_data", sample_data_token)
        sample = self.get("sample", sd["sample_token"])
        scene = self.get("scene", sample["scene_token"])
        map_rec = self._map_by_log.get(scene.get("log_token", ""))
        if map_rec is None or not map_rec.get("filename"):
            return np.zeros((2 * limit_px, 2 * limit_px), np.uint8)
        mask = self._map_mask(map_rec["filename"])
        pose = self.get("ego_pose", sd["ego_pose_token"])
        px = int(round(pose["translation"][0] / res))
        py = int(round(mask.shape[0] - pose["translation"][1] / res))

        # crop with sqrt(2) margin so the subsequent rotation never exposes
        # missing corners
        pad = int(limit_px * math.sqrt(2))
        out = np.zeros((2 * pad, 2 * pad), np.uint8)
        y0, y1 = max(py - pad, 0), min(py + pad, mask.shape[0])
        x0, x1 = max(px - pad, 0), min(px + pad, mask.shape[1])
        if y1 > y0 and x1 > x0:
            out[y0 - (py - pad):y1 - (py - pad),
                x0 - (px - pad):x1 - (px - pad)] = mask[y0:y1, x0:x1]

        Image = _pil_image()
        yaw_deg = -math.degrees(quat_yaw(pose["rotation"]))
        rotated = np.asarray(Image.fromarray(out).rotate(yaw_deg))
        c = rotated.shape[0] // 2
        return rotated[c - limit_px:c + limit_px, c - limit_px:c + limit_px]

    def ann_attribute(self, ann: dict) -> str:
        """First attribute name of an annotation ('' when the annotation
        carries none — nuScenes annotations have 0 or 1 attributes)."""
        toks = ann.get("attribute_tokens") or []
        if not toks or not self._t["attribute"]:
            return ""
        return self.get("attribute", toks[0])["name"]

    def lidar_path(self, sample_data_token: str) -> str:
        sd = self.get("sample_data", sample_data_token)
        return os.path.join(self.dataroot, sd["filename"])

    def ann_category(self, ann: dict) -> str:
        """Raw sample_annotation has no category_name — resolve through the
        instance table (the devkit does this at load time)."""
        if "category_name" in ann:
            return ann["category_name"]
        inst = self.get("instance", ann["instance_token"])
        return self.get("category", inst["category_token"])["name"]


# canonical category -> detection-name mapping (ref nusc_common.py
# general_to_detection)
GENERAL_TO_DETECTION = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.construction": "construction_vehicle",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
}


def detection_name(category: str) -> str:
    return GENERAL_TO_DETECTION.get(category, "ignore")

"""Offline info generation — devkit-free port of `create_nuscenes_infos`
(reference `det3d/datasets/nuscenes/nusc_common.py:396-664`).

The port's copy of `futuredet_tpu/data/infos.py`, writing the same pkls
(the two packages read each other's). Where the JAX module resizes the
ego map with `cv2.resize(..., INTER_CUBIC)`, this one runs the same cubic
filter in numpy (`resize_cubic_u8`), so data preparation needs no OpenCV.

Per sample:
  * sweep chain: walk `prev` links of LIDAR_TOP, composing
    ref_from_car @ car_from_global @ global_from_car @ car_from_current
    (ref :449-505), duplicating the tail when the log starts
  * forecast GT: walk `next` annotation links `timesteps` steps, transform
    every future box into the CURRENT sample's lidar frame (ref
    get_annotations :335-394), classify the tracklet static/linear/nonlinear
    (ref trajectory() :311-333)
  * gt_boxes rows: [loc(3), wlh(3), vel_xy, rvel_xy, -yaw-pi/2, -ryaw-pi/2]
    (ref :531)
"""
from __future__ import annotations

import pickle
from functools import reduce
from typing import List

import numpy as np

from .nuscenes_tables import (NuScenesTables, detection_name, quat_inverse,
                              quat_to_rot, quat_yaw, transform_matrix)


def _cubic_taps(dst: int, src: int):
    """Source indices (dst, 4), clamped to the image (border replicate),
    and weights (dst, 4) of the cubic convolution kernel with a = -0.75 at
    source x = (d + 0.5) * src / dst - 0.5: OpenCV's INTER_CUBIC
    (imgproc/resize.cpp::interpolateCubic) and torch's bicubic with
    align_corners=False."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    w = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1)
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, w


def resize_cubic_u8(img: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(img, dsize=(W, H), interpolation=cv2.INTER_CUBIC)` of a
    (h, w) uint8 image, in numpy: the separable cubic filter of
    `_cubic_taps` in float64, rounded to nearest and saturated to
    [0, 255]. An all-zero image stays exactly zero."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("resize_cubic_u8 takes a 2-D uint8 image")
    W, H = dsize
    xi, xw = _cubic_taps(W, img.shape[1])
    yi, yw = _cubic_taps(H, img.shape[0])
    rows = (img.astype(np.float64)[:, xi] * xw[None]).sum(-1)   # (h, W)
    out = (rows[yi] * yw[:, :, None]).sum(1)                      # (H, W)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _ann_box_in_lidar(nusc: NuScenesTables, ann: dict, pose_rec: dict,
                      cs_rec: dict):
    """Global annotation -> (center, yaw, vel_xy) in the reference lidar frame
    (devkit Box.translate/rotate sequence, ref nusc_common.py:353-365).

    Yaw composes the z-heading of each rotation additively — exact for pure-z
    rotations; nuScenes ego poses carry sub-degree roll/pitch, so the yaw
    error is bounded by that (centers/velocities use the full 3D rotations).
    """
    r_pose_inv = quat_to_rot(quat_inverse(pose_rec["rotation"]))
    r_cs_inv = quat_to_rot(quat_inverse(cs_rec["rotation"]))
    center = np.asarray(ann["translation"], float)
    center = r_pose_inv @ (center - np.asarray(pose_rec["translation"]))
    center = r_cs_inv @ (center - np.asarray(cs_rec["translation"]))

    vel = nusc.box_velocity(ann["token"])
    vel = r_cs_inv @ (r_pose_inv @ vel)

    yaw_global = quat_yaw(ann["rotation"])
    pose_head = quat_yaw(quat_inverse(pose_rec["rotation"]))
    cs_head = quat_yaw(quat_inverse(cs_rec["rotation"]))
    yaw = yaw_global + pose_head + cs_head
    return center, yaw, vel


def _times(nusc: NuScenesTables, tokens: List[str]) -> List[float]:
    ts = [1e-6 * nusc.get("sample", t)["timestamp"] for t in tokens]
    return [b - a for a, b in zip(ts[:-1], ts[1:])]


def _classify(centers, vel_xy, wlh, times) -> str:
    """ref trajectory() :311-333."""
    target = centers[-1]
    thresh = max(wlh[0], wlh[1])
    if np.linalg.norm((target - centers[0])[:2]) < thresh:
        return "static"
    disp = np.asarray(vel_xy) * np.sum(times)
    if np.linalg.norm((target[:2] - (centers[0][:2] + disp))) < thresh:
        return "linear"
    return "nonlinear"


def fill_infos(nusc: NuScenesTables, nsweeps: int = 20, timesteps: int = 7,
               filter_zero: bool = True) -> List[dict]:
    infos = []
    for sample in nusc.table("sample"):
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd = nusc.get("sample_data", ref_sd_token)
        ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]

        ref_from_car = transform_matrix(ref_cs["translation"],
                                        ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"],
                                           ref_pose["rotation"], inverse=True)

        info = {
            "lidar_path": nusc.lidar_path(ref_sd_token),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # sweep chain (ref :449-505)
        curr = ref_sd
        sweeps = []
        while len(sweeps) < nsweeps - 1:
            if curr["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = nusc.get("sample_data", curr["prev"])
                pose = nusc.get("ego_pose", curr["ego_pose_token"])
                cs = nusc.get("calibrated_sensor",
                              curr["calibrated_sensor_token"])
                global_from_car = transform_matrix(pose["translation"],
                                                   pose["rotation"])
                car_from_current = transform_matrix(cs["translation"],
                                                    cs["rotation"])
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": nusc.lidar_path(curr["token"]),
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        # forecast annotations (ref get_annotations :335-394)
        anns = [nusc.get("sample_annotation", t) for t in sample["anns"]]
        n = len(anns)
        gt_boxes = np.zeros((n, timesteps, 12), np.float32)
        gt_names = np.full((n, timesteps), "ignore", object)
        gt_tokens = np.full((n, timesteps), "", object)
        gt_vel = np.zeros((n, timesteps, 3), np.float32)
        gt_traj = np.full((n, timesteps), "static", object)
        gt_attr = np.full((n,), "", object)
        keep = np.zeros(n, bool)

        for i, ann0 in enumerate(anns):
            keep[i] = (ann0["num_lidar_pts"] + ann0["num_radar_pts"]) > 0
            # t=0 attribute for the AAE metric (nuScenes attr_acc compares
            # against the current-sample annotation attribute)
            gt_attr[i] = nusc.ann_attribute(ann0)
            ann = ann0
            tracklet_tokens = []
            centers, yaws, vels = [], [], []
            for t in range(timesteps):
                c, yaw, v = _ann_box_in_lidar(nusc, ann, ref_pose, ref_cs)
                centers.append(c)
                yaws.append(yaw)
                vels.append(np.nan_to_num(v))
                tracklet_tokens.append(ann["sample_token"])
                wlh = ann["size"]
                gt_boxes[i, t] = np.concatenate([
                    c, wlh, vels[-1][:2], vels[-1][:2],
                    [-yaw - np.pi / 2, -yaw - np.pi / 2]])
                gt_names[i, t] = detection_name(nusc.ann_category(ann))
                gt_tokens[i, t] = ann["token"]
                gt_vel[i, t] = vels[-1]
                if ann["next"] != "":
                    ann = nusc.get("sample_annotation", ann["next"])
            times = _times(nusc, tracklet_tokens) or [0.5]
            traj = _classify(centers, vels[0][:2], anns[i]["size"], times)
            gt_traj[i, :] = traj

        sel = keep if filter_zero else np.ones(n, bool)
        info["gt_boxes"] = gt_boxes[sel]
        info["gt_names"] = gt_names[sel]
        info["gt_boxes_token"] = gt_tokens[sel]
        info["gt_boxes_rtoken"] = gt_tokens[sel]
        info["gt_boxes_velocity"] = gt_vel[sel]
        info["gt_boxes_rvelocity"] = gt_vel[sel]
        info["gt_trajectory"] = gt_traj[sel]
        info["gt_attributes"] = gt_attr[sel]
        # per-sample keyframe gaps over the forecast horizon (ref get_time,
        # nuscenes.py:57-62; tokens clamp at scene end like get_token :64-76,
        # so trailing gaps go to 0)
        toks = [sample["token"]]
        cur = sample
        for _ in range(timesteps - 1):
            if cur["next"] != "":
                cur = nusc.get("sample", cur["next"])
            toks.append(cur["token"])
        info["sample_times"] = np.asarray(_times(nusc, toks), np.float32)
        # ego-centric BEV map, 80 m crop resized to 180x180 (ref
        # nusc_common.py:508-509); zeros when the dataset ships no map table
        ego_map = nusc.get_ego_centric_map(sweeps[0]["sample_data_token"])
        info["bev"] = resize_cubic_u8(ego_map, (180, 180))
        infos.append(info)
    return infos


def create_nuscenes_infos(root_path: str, version: str = "v1.0-trainval",
                          nsweeps: int = 20, timesteps: int = 7,
                          filter_zero: bool = True):
    """Write infos_{train,val} pkls in the reference naming scheme
    (ref :654-664)."""
    nusc = NuScenesTables(root_path, version)
    infos = fill_infos(nusc, nsweeps, timesteps, filter_zero)

    # official scene splits (ref nusc_common.py:605-625 via the devkit's
    # splits module; vendored in data.splits)
    from .splits import split_scenes
    scene_names = {s["token"]: s["name"] for s in nusc.table("scene")}
    _, val_names = split_scenes(scene_names.values(), version)
    val_set = set(val_names)
    tr, va = [], []
    for info in infos:
        scene_tok = nusc.get("sample", info["token"])["scene_token"]
        (va if scene_names[scene_tok] in val_set else tr).append(info)

    suffix = f"{nsweeps}sweeps_withvelo_filter_{filter_zero}"
    out = []
    for name, data in (("train", tr), ("val", va)):
        path = f"{root_path}/infos_{name}_{suffix}.pkl"
        with open(path, "wb") as f:
            pickle.dump(data, f)
        out.append(path)
    return out
